"""Simulation engine: the reference's threaded step loop on torch tensors.

Counterpart of ``physicl_tpu/engine.py`` for the fused tier. The surface is
the same — ``Simulation(**kwargs)``, ``add_step`` (insertion-order
execution), ``add_obj`` / ``add_photons``, ``start()`` / ``join()`` with the
thread's exception re-raised, ``get_state()``, ``sim.ts``, ``step.data`` and
``terminate`` with CSV output — and the run is driven as pipelined chunks
of up to 1024 iterations by :class:`physicl_tpu_torch.ops.pipeline.
FusedProvider`.

Between chunks the engine recycles a continuous source's dead slots
(:mod:`physicl_tpu_torch.population`). Not ported yet, and refused with
``NotImplementedError`` rather than run differently: the generic step tier
(the steps' ``apply``), the rest of population maintenance (mid-run
injection/removal, ``auto_shrink``), checkpoints, device meshes and the
spatial sort.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.state import (OBJ_GENERIC, OBJ_PHOTON, SimState,
                                     pad_capacity)
from physicl_tpu_torch.units import Measurement, raw_code_value

__all__ = ["Step", "UpdateTimeStep", "MeasureStep", "Object", "Simulation",
           "IndexException", "UntilT", "ExtinctionExit", "PlanReport",
           "ParticleView", "ElementwiseStep", "ReduceMeasureStep"]


_RECORD_BUDGET_MIN = 256 << 20
_RECORD_BUDGET_MAX = 2 << 30


def _default_record_budget(device: torch.device) -> int:
    """Per-dispatch stream budget: the card's memory / 8 clamped to [256
    MB, 2 GB] (two budgets can be in flight, and the state needs the
    rest); 2 GB on the CPU, where host memory is not the constraint."""
    if device.type != "cuda":
        return _RECORD_BUDGET_MAX
    total = torch.cuda.get_device_properties(device).total_memory
    return max(_RECORD_BUDGET_MIN, min(_RECORD_BUDGET_MAX, total // 8))


class IndexException(Exception):
    """Raised when adding a step at an occupied index."""


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to physicl_tpu_torch "
                              "yet (fused main path only)")


class Step:
    """Base step. Host lifecycle: ``setup(sim)`` before the run,
    ``collect(sim, records)`` after each chunk with this step's record
    arrays (trimmed to valid iterations), ``terminate(sim)`` at exit. The
    per-iteration physics runs inside the fused chunk."""

    _step_uid: str = ""

    def setup(self, sim: "Simulation") -> None:
        pass

    def collect(self, sim: "Simulation", records: Dict[str, np.ndarray]) -> None:
        pass

    def terminate(self, sim: "Simulation") -> None:
        pass


class UpdateTimeStep(Step):
    """Advances the clock: ``dt = fn(sim); t += dt`` and logs ``sim.ts``.
    On the fused tier the clock is replayed on the host (Kahan-compensated
    f32, bit-identical to the JAX package), so this step holds ``fn`` and
    collects ``sim.ts``."""

    def __init__(self, fn: Callable[[Any], Any]):
        super().__init__()
        self.fn = fn

    def collect(self, sim: "Simulation", records: Dict[str, np.ndarray]) -> None:
        sim.ts.extend(float(x) for x in records["ts"])


class MeasureStep(Step):
    """Accumulates ``self.data`` rows; ``terminate`` writes CSV to ``out_fn``."""

    def __init__(self, out_fn: Optional[str] = None):
        super().__init__()
        self.out_fn = out_fn
        self.data: List[Any] = []

    def terminate(self, sim: "Simulation") -> None:
        if self.out_fn is None:
            return
        from physicl_tpu_torch.utils.io import write_rows

        if isinstance(self.data, dict):
            rows = [[k, *v] if isinstance(v, (list, tuple, np.ndarray))
                    else [k, v] for k, v in self.data.items()]
        else:
            rows = self.data
        write_rows(self.out_fn, rows)


class ParticleView:
    """Per-particle elementwise view handed to :class:`ElementwiseStep` and
    :class:`ReduceMeasureStep` functions: component planes ``rx..rz,
    drx..drz, vx..vz, dvx..dvz, E``, the weight ``w``, the bool ``alive``
    mask, the 0-d ``t`` and ``dt`` of the step's place, ``uniform()`` for a
    per-particle U[0, 1) draw, and ``p.extras["name"]`` for each declared
    extras plane (one tensor for a scalar plane, a tuple of three for a
    3-row one). Write elementwise torch code: the fused tier records the
    function once, at plan time, into a program the transport kernel runs
    for every particle (:mod:`physicl_tpu_torch.ops.record`)."""

    _FIELDS = ("rx", "ry", "rz", "drx", "dry", "drz",
               "vx", "vy", "vz", "dvx", "dvy", "dvz", "E", "alive", "w")

    def __init__(self, fields: Dict[str, Any], t, dt, uniform, extras=None):
        for k, v in fields.items():
            setattr(self, k, v)
        self.t = t
        self.dt = dt
        self.uniform = uniform
        self.extras = extras or {}


_MISSING_EXTRAS_MSG = (
    "step declares extras={names} but the population carries no '{name}' "
    "plane: attach it to the initial population (Object kwargs, bulk "
    "dict 'extras', or polarization.polarized_photon_state for Stokes "
    "planes)")


def _check_extras_decl(extras, who: str) -> tuple:
    extras = tuple(extras)
    if not all(isinstance(n, str) and n for n in extras):
        raise TypeError(f"{who} extras= must be a tuple of plane names, "
                        f"got {extras!r}")
    return extras


def _generic_tier(step):
    raise NotImplementedError(f"{type(step).__name__}.apply is the generic "
                              "step tier, which is not ported; the fused "
                              "tier runs this step in the transport kernel")


class ElementwiseStep(Step):
    """User-defined per-particle physics on the fused tier.

    ``fn(p: ParticleView) -> dict`` returns updated fields by name (any
    subset of ``ParticleView._FIELDS``). The contract that makes it fusable:

    * elementwise over the particle axis: no reductions, gathers or
      cross-particle mixing, checked when the fn is recorded (a refusal
      ``elementwise-not-elementwise``; an operation outside the kernel's
      table is ``elementwise-op-unsupported``, Python control flow on a
      value ``elementwise-trace``);
    * only the transport fields, plus extras planes declared with
      ``extras=("name", ...)`` (``p.extras["name"]``). Planes also listed in
      ``extras_write=`` may be returned (a scalar plane: one tensor; a
      3-row plane: three) and are written back into ``sim_state.extras``;
    * randomness only through ``p.uniform()`` (the kernel's counter hash,
      draw for draw the JAX package's);
    * a returned ``alive`` only clears (it is AND-ed with the mask).

    Example, a time-dependent absorber keeping each photon's dose::

        def decay(p):
            u = p.uniform()
            hit = (u < 0.1 * torch.exp(-p.t) * p.dt) & p.alive
            return {"alive": ~hit,
                    "dose": p.extras["dose"] + hit * p.E}

        sim.add_step(3, ElementwiseStep(decay, extras_write=("dose",)))
    """

    def __init__(self, fn: Callable[[ParticleView], Dict[str, Any]],
                 extras: tuple = (), extras_write: tuple = ()):
        super().__init__()
        self.fn = fn
        self.extras_write = _check_extras_decl(extras_write,
                                               "ElementwiseStep")
        # writable planes are implicitly readable (one declaration each)
        self.extras = tuple(dict.fromkeys(
            _check_extras_decl(extras, "ElementwiseStep")
            + self.extras_write))

    def apply(self, state, ctx):
        _generic_tier(self)


class ReduceMeasureStep(MeasureStep):
    """User-defined per-particle measurement on the fused tier, the
    measurement counterpart of :class:`ElementwiseStep`.

    ``fn(p: ParticleView) -> dict`` returns named per-particle
    contributions; each iteration records their sums over ALIVE particles
    in float record columns. ``data`` rows are ``[t(, n), sum_0, sum_1,
    ...]`` in ``outputs`` order, with CSV via ``out_fn``. Same contract as
    ElementwiseStep, read-only (``extras=`` planes readable). Example::

        def moments(p):
            r2 = p.rx ** 2 + p.ry ** 2 + p.rz ** 2
            return {"E_total": p.E, "r2": r2}

        sim.add_step(4, ReduceMeasureStep(None, moments,
                                          outputs=("E_total", "r2")))
    """

    def __init__(self, out_fn=None, fn: Callable[[ParticleView],
                                                 Dict[str, Any]] = None,
                 outputs=(), measure_n: bool = False, extras: tuple = ()):
        super().__init__(out_fn)
        if fn is None or not outputs:
            raise ValueError(
                "ReduceMeasureStep needs fn and a non-empty outputs tuple")
        self.fn = fn
        self.extras = _check_extras_decl(extras, "ReduceMeasureStep")
        self.outputs = tuple(outputs)
        if {"t", "n"} & set(self.outputs):
            raise ValueError(
                "'t' and 'n' are reserved record names; rename the output")
        self.measure_n = measure_n

    def _contributions(self, view: ParticleView) -> Dict[str, Any]:
        contrib = self.fn(view)
        missing = set(self.outputs) - set(contrib)
        if missing:
            raise ValueError(
                f"ReduceMeasureStep fn did not return declared outputs "
                f"{sorted(missing)}")
        return contrib

    def apply(self, state, ctx):
        _generic_tier(self)

    def collect(self, sim: "Simulation", records) -> None:
        for i in range(len(records["t"])):
            row = [float(records["t"][i])]
            if self.measure_n:
                row.append(int(records["n"][i]))
            row.extend(float(records[name][i]) for name in self.outputs)
            self.data.append(row)


class Object:
    """Generic particle (host-side constructor; becomes one state slot)."""

    _obj_type_code = 0

    def __init__(self, **kwargs):
        self.r = Measurement([0.0] * 3, "m**1")
        self.dr = Measurement([0.0] * 3, "m**1")
        self.dv = Measurement([0.0] * 3, "m**1 s**-1")
        self.v = Measurement([0.0] * 3, "m**1 s**-1")
        self.a = Measurement([0.0] * 3, "m**1 s**-2")
        for attr, val in kwargs.items():
            setattr(self, attr, val)


def _default_exit(view):
    return view.n_objects == 0


class ExtinctionExit:
    """Declared 'run until no objects remain' exit (``exit="extinction"``)."""

    exit_mode_hint = "n0"

    def __call__(self, view):
        return view.n_objects == 0

    def __repr__(self):
        return "ExtinctionExit()"


class UntilT:
    """Declared 'run until sim.t >= T' exit (``Simulation(until_t=T)``)."""

    exit_mode_hint = "t"

    def __init__(self, T):
        self.T = float(raw_code_value(T))

    def __call__(self, view):
        return view.t >= self.T

    def __repr__(self):
        return f"UntilT({self.T!r})"


@dataclasses.dataclass
class PlanReport:
    """Why the engine chose its execution strategy (``sim.explain_plan()``).

    ``mode`` is ``"fused"`` or, when the prover refused, ``"unsupported"``
    (the generic tier is not ported, so ``start()`` raises the refusal)."""

    mode: str
    chunk: int
    fuse_setting: str
    allow_fuse: bool
    exit_tier: str
    refusals: List[tuple] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        lines = [f"execution mode: {self.mode} "
                 f"(chunk={self.chunk} iterations/dispatch)",
                 f"exit handling: {self.exit_tier}"]
        if self.mode == "fused":
            lines.append("the whole step pipeline runs as one fused chunk: "
                         "the fused_transport CUDA kernel on a CUDA device, "
                         "its plain PyTorch twin on the CPU")
        for code, detail in self.refusals:
            lines.append(f"fused pipeline refused [{code}]: {detail}")
        if self.mode == "unsupported":
            lines.append("the generic step tier is not ported: start() "
                         "raises this refusal")
        lines.extend(self.notes)
        return "\n".join(lines)


class _PendingPopulation:
    """Pre-run ``sim.objects`` when bulk populations are queued (len only)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def __len__(self):
        return len(self._sim._pending_objects) + sum(
            int(b["n"]) for b in self._sim._pending_bulk)

    def __iter__(self):
        _not_ported("materializing bulk photons as objects")


class _HostObjectsProxy:
    """``sim.objects`` during/after a run: ``len()`` is the alive count."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def __len__(self):
        return int(self._sim._host_n_alive)

    def __iter__(self):
        _not_ported("materializing device state as objects")


class Simulation(threading.Thread):
    """Threaded simulation driver (the JAX package's ``Simulation``).

    ``device`` (default ``"cuda"``) places the state and every launch;
    ``seed`` keys the fused tier's counter hash exactly as in the JAX
    package, so a CPU run reproduces the JAX package's CPU run draw for
    draw. ``fused_pipeline_depth`` chunks stay in flight beyond the one
    being harvested. ``chunk_log`` collects ``(perf_counter, n_valid,
    event)`` at every harvest; ``event`` is the timed CUDA event recorded
    after the chunk (None on the CPU), so a rate over the dispatch loop can
    be read on the device's clock, where a late harvest does not skew it.

    ``setup_seconds`` is the host time from ``start()`` to the first
    dispatch (state build, step setup, prover).

    ``population_log`` lists the run's arena events: ``("capacity-stop",
    chunk index, iteration, spawn mark)`` where a continuous source finds
    the arena full, and ``("recycle", chunk index, spawn mark before,
    spawn mark after)`` where the engine compacts it.

    ``max_record_bytes`` caps one dispatch's stream buffer (trace
    positions, captured energies): by default the card's memory / 8 clamped
    to [256 MB, 2 GB], 2 GB on the CPU; assign it to override. Plans with
    stream planes keep at most 2 chunks in flight beyond the harvested one.

    ``sim_state`` is the state of the newest dispatched chunk: each chunk
    writes its own packed buffer, so it is a snapshot that later chunks do
    not overwrite, but on a CUDA device its values are final only once the
    chunk has run (reads are stream-ordered, so they wait for it).
    """

    def __init__(self, **kwargs):
        threading.Thread.__init__(self)
        self.exit = _default_exit
        self.bounds = np.zeros(3)  # the reference's box [0, b] per axis
        self.state_fn = lambda x: {
            "objects": len(x.objects),
            "t": x.t,
            "dt": x.dt,
            "run_time": time.time() - x.start_time,
        }
        self.state_need_lock = False
        self.chunk_steps: Optional[int] = None
        self.seed = 0
        self.dtype = torch.float32
        self.capacity: Optional[int] = None
        self.device = "cuda"
        self.fuse = "auto"
        self.fused_pipeline_depth = 4
        self.mesh = None
        self._max_record_bytes: Optional[int] = None
        # population maintenance is not ported: the JAX default (True)
        # would compact the population, so the port defaults to off and
        # refuses True
        self.auto_shrink = False
        self.spatial_sort = 0
        self.until_t = None
        for attr, val in kwargs.items():
            setattr(self, attr, val)
        if self.until_t is not None:
            if self.exit is not _default_exit:
                raise ValueError(
                    "pass either until_t=... or exit=..., not both")
            self.exit = UntilT(self.until_t)
        if isinstance(self.exit, str):
            if self.exit != "extinction":
                raise ValueError(
                    f"unknown exit mode {self.exit!r}; string form accepts "
                    "'extinction' (run until no objects remain)")
            self.exit = ExtinctionExit()
        self.device = torch.device(self.device)

        self.plan_report: Optional[PlanReport] = None
        self.used_fused = False
        self.dt = Measurement(np.double(0), "s**1")
        self.t = Measurement(np.double(0), "s**1")
        self._pending_objects: List[Object] = []
        self._pending_bulk: List[Dict[str, Any]] = []
        self.steps: Dict[int, Step] = {}
        self._state_lock = threading.Lock()
        self.running = False
        self.start_time = 0.0
        self.run_time = 0.0
        self.ts: List[float] = []
        self.sim_state: Optional[SimState] = None
        self.chunk_log: List[tuple] = []
        self.population_log: List[tuple] = []
        self.setup_seconds: Optional[float] = None
        self._host_n_alive = 0
        self._initial_count = 0  # slots of the initial population
        self._hwm = 0            # spawn mark (trace rows cover [0, hwm))

    @property
    def max_record_bytes(self) -> int:
        if self._max_record_bytes is not None:
            return self._max_record_bytes
        return _default_record_budget(self.device)

    @max_record_bytes.setter
    def max_record_bytes(self, v: int) -> None:
        self._max_record_bytes = int(v)

    # -- population --------------------------------------------------------

    @property
    def objects(self):
        if self.sim_state is None and not self.running:
            if not self._pending_bulk:
                return self._pending_objects
            return _PendingPopulation(self)
        return _HostObjectsProxy(self)

    def add_obj(self, obj: Object) -> None:
        if self.running:
            _not_ported("mid-run add_obj (population maintenance)")
        self._pending_objects.append(obj)

    def add_objs(self, objs) -> None:
        for o in objs:
            self.add_obj(o)

    def add_photons(self, bulk: Dict[str, Any]) -> None:
        """Add a bulk population from
        :func:`physicl_tpu_torch.light.generate_photon_state`."""
        if self.running:
            _not_ported("mid-run add_photons (population maintenance)")
        self._pending_bulk.append(bulk)

    def add_particles(self, bulk: Dict[str, Any]) -> None:
        """Add any bulk population dict: photons
        (:func:`physicl_tpu_torch.light.generate_photon_state`) or massive
        and charged particles
        (:func:`physicl_tpu_torch.newton.generate_particle_state`); its
        ``otype`` key carries the species. Alias of :meth:`add_photons`."""
        self.add_photons(bulk)

    def remove_obj(self, obj: Object) -> None:
        if self.running:
            _not_ported("mid-run remove_obj (population maintenance)")
        self._pending_objects.remove(obj)

    def add_step(self, idx: int, step: Step) -> None:
        if idx in self.steps:
            raise IndexException("Cannot add a step to an existing index.")
        self.steps[idx] = step

    def remove_step(self, idx: int) -> None:
        if self.running:
            raise RuntimeError(
                "Cannot remove a Step while the simulation is running.")
        self.steps.pop(idx)

    def save_checkpoint(self, path: str) -> None:
        _not_ported("save_checkpoint")

    def restore_checkpoint(self, path: str) -> None:
        _not_ported("restore_checkpoint")

    def get_state(self):
        if self.state_need_lock:
            with self._state_lock:
                return self.state_fn(self)
        return self.state_fn(self)

    # -- planning ------------------------------------------------------------

    def _population_policies(self):
        """``(recycle_ok, emit_per_iter)``: a continuous source recycles
        slots unless a step needs stable slot ids (a trace's rows are
        slots); emission then stops at capacity. (Shrinking, the JAX
        package's other slot-moving policy, is not ported:
        ``auto_shrink=True`` is refused.)"""
        steps = list(self.steps.values())
        stable_ids = any(getattr(s, "needs_stable_ids", False)
                         for s in steps)
        emit_per_iter = sum(
            getattr(s, "n_per_step", 0) for s in steps
            if getattr(s, "needs_capacity_headroom", False))
        return emit_per_iter > 0 and not stable_ids, emit_per_iter

    def _ordered_steps(self) -> List[Step]:
        # insertion order, NOT index order (reference semantics)
        steps = list(self.steps.values())
        for i, s in enumerate(steps):
            s._step_uid = f"s{i}"
        return steps

    def _check_supported(self) -> None:
        if self.dtype != torch.float32:
            _not_ported(f"dtype={self.dtype} (the fused tier is float32)")
        if self.fuse != "auto":
            _not_ported(f"fuse={self.fuse!r} (the generic step tier)")
        if self.mesh is not None:
            _not_ported("mesh= (multi-device runs)")
        if int(self.spatial_sort or 0):
            _not_ported("spatial_sort=")
        if self.auto_shrink:
            _not_ported("auto_shrink=True (population maintenance)")

    def _init_run_state(self) -> SimState:
        n0 = len(self._pending_objects) + sum(
            int(b["n"]) for b in self._pending_bulk)
        cap = (self.capacity if self.capacity is not None
               else pad_capacity(max(n0, 1)))
        state = SimState.from_population(
            self._pending_objects, self._pending_bulk, device=self.device,
            seed=self.seed, capacity=cap)
        self._host_n_alive = n0
        self._initial_count = self._hwm = n0
        self.sim_state = state
        return state

    def _build_execution(self, steps: List[Step], state: SimState):
        from physicl_tpu_torch.ops.pipeline import try_build_fused

        provider = try_build_fused(self, steps, state)
        plan = provider.plan
        notes = [f"device: {self.device}",
                 "population species: " + {
                     OBJ_PHOTON: "photon", OBJ_GENERIC: "generic"}.get(
                         plan.species, "mixed (otype-plane dispatch)"),
                 "const-norm |dr| = c*dt: "
                 + ("on" if plan.const_norm_speed is not None else "off")]
        if plan.extras:
            notes.append("packed per-particle planes: 15 core + "
                         + " + ".join(plan.extras))
        if plan.extras_writeback:
            # the Stokes and frame rows come back from the kernel into
            # sim_state.extras after every chunk
            notes.append("kernel writes back: "
                         + ", ".join(plan.extras_writeback))
        self.plan_report = PlanReport(
            mode="fused", chunk=plan.chunk, fuse_setting=self.fuse,
            allow_fuse=True,
            exit_tier=("t-schedule (exit iteration precomputed on host)"
                       if provider.exit_mode == "t"
                       else "extinction (in-kernel alive count)"),
            notes=notes + provider.notes)
        return provider

    def explain_plan(self) -> str:
        """Human-readable account of the execution strategy. Callable before
        ``start()`` (plans on a transient state without running) or after."""
        if self.plan_report is None:
            from physicl_tpu_torch.ops.pipeline import FusedRefusal

            prior = self.sim_state
            try:
                self._check_supported()
                steps = self._ordered_steps()
                state = self._init_run_state()
                for s in steps:
                    s.setup(self)
                self._build_execution(steps, state)
            except FusedRefusal as e:
                return PlanReport(
                    mode="unsupported", chunk=-1, fuse_setting=self.fuse,
                    allow_fuse=True, exit_tier="n/a",
                    refusals=[(e.code, e.detail)]).describe()
            finally:
                self.sim_state = prior
        return self.plan_report.describe()

    # -- run loop ------------------------------------------------------------

    def run(self) -> None:
        """Thread body: captures exceptions so ``join()`` re-raises them."""
        try:
            self._run_impl()
        except BaseException as e:  # noqa: BLE001 — resurfaced in join()
            self.exception = e
            self.running = False
            raise

    def join(self, timeout=None):
        threading.Thread.join(self, timeout)
        exc = getattr(self, "exception", None)
        if exc is not None:
            self.exception = None
            raise exc

    def _collect_records(self, steps, records, n_valid) -> None:
        """Hand each step its records trimmed to the valid iterations.
        Host records are numpy arrays (the trim is a view); stream records
        take the trim as a bound and copy nothing."""
        for s in steps:
            prefix = f"{s._step_uid}/"
            local = {k[len(prefix):]: v[:n_valid]
                     for k, v in records.items() if k.startswith(prefix)}
            if local:
                s.collect(self, local)

    def _harvest_fused(self, provider, inflight, steps):
        done, final_state, records, n_valid, stats = provider.harvest(inflight)
        self.chunk_log.append((time.perf_counter(), n_valid, inflight.ready))
        with self._state_lock:
            if done:
                self.sim_state = final_state
            self._host_n_alive = stats["n_alive"]
            self.t = Measurement.from_code(stats["t"], "s**1")
            self.dt = Measurement.from_code(stats["dt"], "s**1")
        self._collect_records(steps, records, n_valid)
        return done, final_state

    def _drive_fused(self, provider, steps, state: SimState) -> SimState:
        """Pipelined dispatch loop: enqueue chunk k+1 before waiting on
        chunk k's records, keeping up to ``fused_pipeline_depth`` chunks in
        flight; returns the definitive final state. Slot recycling needs a
        fresh alive count, so the pipeline drains before it runs."""
        from physicl_tpu_torch.population import PopulationManager

        depth = max(1, int(self.fused_pipeline_depth))
        if provider.plan.n_stream:
            # each chunk in flight holds up to max_record_bytes of stream
            depth = min(depth, 2)
        pending: deque = deque()
        pop = PopulationManager(self)

        def drain_one():
            return self._harvest_fused(provider, pending.popleft(), steps)

        while True:
            if pop.needs_attention(state, provider):
                while pending:
                    done, final_state = drain_one()
                    if done:
                        return final_state
                state = pop.maintain(state, provider)
            inflight = provider.dispatch(state)
            state = inflight.state
            with self._state_lock:
                self.sim_state = state
            pending.append(inflight)
            if inflight.done_t:  # t-mode exit inside this chunk
                while pending:
                    done, final_state = drain_one()
                    if done:
                        return final_state
            while len(pending) > depth:
                done, final_state = drain_one()
                if done:  # later pending chunks were speculative overshoot
                    return final_state

    def _run_impl(self) -> None:
        self._check_supported()
        t0 = time.perf_counter()
        self.start_time = time.time()
        self.ts = []
        self.chunk_log = []
        self.population_log = []
        self.running = True
        state = self._init_run_state()
        steps = self._ordered_steps()
        for s in steps:
            s.setup(self)
        provider = self._build_execution(steps, state)
        self.used_fused = True
        self.setup_seconds = time.perf_counter() - t0
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._drive_fused(provider, steps, state)
        else:
            self._drive_fused(provider, steps, state)
        with self._state_lock:
            for s in steps:
                s.terminate(self)
            self.run_time = time.time() - self.start_time
            self.running = False
