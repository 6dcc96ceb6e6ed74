"""Simulation engine: the reference's threaded step loop on torch tensors.

Counterpart of ``physicl_tpu/engine.py``. The surface is the same —
``Simulation(**kwargs)``, ``add_step`` (insertion-order execution),
``add_obj`` / ``add_photons``, ``start()`` / ``join()`` with the thread's
exception re-raised, ``get_state()``, ``sim.ts``, ``step.data`` and
``terminate`` with CSV output — and so are the two execution tiers:

* the fused tier: pipelined chunks of up to 1024 iterations served by
  :class:`physicl_tpu_torch.ops.pipeline.FusedProvider` (the hand-written
  ``fused_transport`` kernel on a card, its plain twin on the CPU), wherever
  the prover accepts the plan;
* the generic tier: every step's ``apply`` as PyTorch tensor ops, iterated
  in chunks by an early-exit loop (:meth:`Simulation._build_chunk_fn`),
  where the prover refuses the plan or ``fuse="off"``. An exit predicate
  that reads ``len(sim.objects)`` or other host values runs it one
  iteration per chunk (host-exact mode).

Between chunks the engine recycles a continuous source's dead slots and
applies chunk-boundary population control
(:mod:`physicl_tpu_torch.population`). Not ported yet, and refused with
``NotImplementedError`` rather than run differently: the rest of population
maintenance (mid-run injection/removal, ``auto_shrink``), checkpoints,
device meshes and the spatial sort.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.state import (OBJ_GENERIC, OBJ_PHOTON, SimState,
                                     pad_capacity)
from physicl_tpu_torch.units import Measurement, raw_code_value

__all__ = ["Step", "UpdateTimeStep", "MeasureStep", "Object", "Simulation",
           "IndexException", "UntilT", "ExtinctionExit", "PlanReport",
           "ParticleView", "ElementwiseStep", "ReduceMeasureStep",
           "StepContext"]


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


class _HostOnlyPredicate(Exception):
    """Signals during probing that an exit predicate needs host values."""


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to physicl_tpu_torch "
                              "yet")


# ---------------------------------------------------------------------------
# Step protocol
# ---------------------------------------------------------------------------


class StepContext:
    """Per-iteration context handed to ``Step.apply`` on the generic tier.

    ``generator`` is the run's ``torch.Generator`` (``SimState.key``), on
    the state's device; ``record(step, name, value)`` is the record sink
    (one device row per iteration, fetched once per chunk); ``sim`` is the
    :class:`Simulation` (None at a chunk boundary).

    The draw contract: ``uniform(shape, dtype)`` is the only draw
    primitive. Every ``jax.random.uniform(<key>, shape, dtype)`` of the JAX
    package's ``apply`` (each key from ``ctx.next_key()`` or a
    ``fold_in`` of one) is one ``ctx.uniform`` call here, in the same order
    and with the same shape and dtype. The streams differ (a torch
    generator is not threefry), but a context that replays the JAX draws
    makes the two ``apply`` compute the same function, which is how the
    tests hold each step against its reference. A callable energy sampler
    (``PhotonEmitterStep(E=f)``) takes ``(generator, k)`` and draws from
    the generator itself.
    """

    def __init__(self, generator: Optional[torch.Generator], sim,
                 device=None):
        self.generator = generator
        self.sim = sim
        self.device = torch.device(
            device if device is not None else generator.device)
        self.records: Dict[str, torch.Tensor] = {}

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        """U[0, 1) of ``shape`` and ``dtype`` on the state's device."""
        shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
        return torch.rand(shape, generator=self.generator, dtype=dtype,
                          device=self.device)

    def record(self, step: "Step", name: str, value) -> None:
        self.records[f"{step._step_uid}/{name}"] = value


class Step:
    """Base step. Host lifecycle: ``setup(sim)`` before the run,
    ``collect(sim, records)`` after each chunk with this step's record
    arrays (trimmed to valid iterations), ``terminate(sim)`` at exit. The
    per-iteration physics runs inside the fused chunk, or on the generic
    tier as ``apply(state, ctx) -> state`` (identity by default).

    ``generic_missing`` names the roadmap item that ports a step's generic
    ``apply`` where the port still lacks it; such a step runs only on the
    fused tier."""

    _step_uid: str = ""
    generic_missing: Optional[str] = None

    def setup(self, sim: "Simulation") -> None:
        pass

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self.generic_missing is not None:
            _generic_missing(self)
        return state

    def collect(self, sim: "Simulation", records: Dict[str, np.ndarray]) -> None:
        pass

    def terminate(self, sim: "Simulation") -> None:
        pass


def _generic_missing(step):
    raise NotImplementedError(
        f"{type(step).__name__}.apply is the generic step tier, not ported "
        f"for this step yet ({step.generic_missing}); the fused tier runs "
        "it in the transport kernel")


def _full_like(value, like: torch.Tensor) -> torch.Tensor:
    """0-d tensor of ``like``'s dtype and device holding ``value`` rounded
    to that dtype (``jnp.asarray(value, dtype)``): a fill, no host copy."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype).reshape(())
    if isinstance(value, Measurement):
        value = raw_code_value(value)
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


class UpdateTimeStep(Step):
    """Advances the clock: ``dt = fn(sim); t += dt`` and logs ``sim.ts``.
    ``fn`` receives a view with ``.t``, ``.dt``, ``.n_objects``. The clock
    is Kahan-compensated in the state's dtype (``t_comp``): on the generic
    tier three device scalar operations an iteration, on the fused tier the
    same arithmetic replayed on the host, so ``sim.ts`` is bit-identical to
    the JAX package's on either tier."""

    def __init__(self, fn: Callable[[Any], Any]):
        super().__init__()
        self.fn = fn

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        dt = _full_like(self.fn(_TracedView(state, ctx.sim)), state.t)
        # y = dt - comp; t = t + y; comp = (t - t_old) - y: adds and
        # subtracts only, one kernel each, so nothing can contract them
        comp = state.t_comp
        y = dt - comp
        t = state.t + y
        comp = (t - state.t) - y
        ctx.record(self, "ts", t)
        return state.replace(t=t, dt=dt, t_comp=comp)

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
    for every particle (:mod:`physicl_tpu_torch.ops.record`); the generic
    tier calls it on the whole ``(C,)`` planes."""

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


def _state_particle_view(state: SimState, ctx: StepContext,
                         extras_decl=()) -> ParticleView:
    """Generic-tier ParticleView over the full state: each ``uniform()``
    is one ``ctx.uniform`` of the planes' shape."""
    fields = {"E": state.E, "alive": state.alive, "w": state.w}
    for base in ("r", "dr", "v", "dv"):
        for i, ax in enumerate("xyz"):
            fields[base + ax] = getattr(state, base)[i]

    def uniform():
        return ctx.uniform(state.E.shape, state.E.dtype)

    ex = {}
    for name in extras_decl:
        if name not in state.extras:
            raise ValueError(_MISSING_EXTRAS_MSG.format(
                names=tuple(extras_decl), name=name))
        arr = state.extras[name]
        ex[name] = (arr if arr.dim() == 1
                    else tuple(arr[i] for i in range(arr.shape[0])))
    return ParticleView(fields, state.t, state.dt, uniform, extras=ex)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


class ElementwiseStep(Step):
    """User-defined per-particle physics.

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
      draw for draw the JAX package's, on the fused tier; the run's
      generator on the generic tier);
    * a returned ``alive`` only clears (it is AND-ed with the mask).

    A refused fn runs on the generic tier, which calls it on the whole
    planes. Example, a time-dependent absorber keeping each photon's dose::

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

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        upd = self.fn(_state_particle_view(state, ctx, self.extras))
        bad = set(upd) - set(ParticleView._FIELDS) - set(self.extras_write)
        if bad:
            raise ValueError(
                f"ElementwiseStep returned unknown fields {bad} (transport "
                f"fields or extras_write={self.extras_write} only)")

        def vec(base):
            names = [base + ax for ax in "xyz"]
            cur = getattr(state, base)
            if not any(n in upd for n in names):
                return cur
            return torch.stack([_as(upd.get(n, cur[i]), cur)
                                for i, n in enumerate(names)])

        out = state.replace(r=vec("r"), dr=vec("dr"), v=vec("v"),
                            dv=vec("dv"))
        if "E" in upd:
            out = out.replace(E=_as(upd["E"], state.E))
        if "w" in upd:
            out = out.replace(w=_as(upd["w"], state.w))
        if "alive" in upd:
            out = out.replace(alive=state.alive & _as(upd["alive"],
                                                      state.alive))
        written = [n for n in self.extras_write if n in upd]
        if written:
            new_extras = dict(state.extras)
            for name in written:
                cur = state.extras[name]
                val = upd[name]
                if cur.dim() == 1:
                    new_extras[name] = _as(val, cur)
                else:
                    comps = tuple(val)
                    if len(comps) != cur.shape[0]:
                        raise ValueError(
                            f"extras_write plane {name!r} has "
                            f"{cur.shape[0]} rows; update returned "
                            f"{len(comps)} components")
                    new_extras[name] = torch.stack([_as(v, cur[0])
                                                    for v in comps])
            out = out.replace(extras=new_extras)
        return out


class ReduceMeasureStep(MeasureStep):
    """User-defined per-particle measurement, the measurement counterpart
    of :class:`ElementwiseStep`.

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

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        contrib = self._contributions(
            _state_particle_view(state, ctx, self.extras))
        for name in self.outputs:
            val = torch.as_tensor(contrib[name], dtype=torch.float32,
                                  device=state.device)
            ctx.record(self, name, torch.where(state.alive, val, 0.0).sum())
        return state

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


# ---------------------------------------------------------------------------
# Views handed to user lambdas (exit, state_fn, dt fn)
# ---------------------------------------------------------------------------


class _TracedObjectsProxy:
    """``sim.objects`` inside a device-evaluated predicate: ``len()`` is a
    host value, so a predicate that calls it runs in host-exact mode."""

    def __len__(self):
        raise _HostOnlyPredicate("len(sim.objects) is a host value")

    def __iter__(self):
        raise _HostOnlyPredicate("sim.objects is a host value")


class _TracedView:
    """Device stand-in for the ``Simulation`` passed to user lambdas on the
    generic tier: ``t``, ``dt`` and ``n_objects`` are 0-d device tensors."""

    def __init__(self, state: SimState, sim):
        self._state = state
        self.bounds = getattr(sim, "bounds", None)

    @property
    def t(self):
        return self._state.t

    @property
    def dt(self):
        return self._state.dt

    @property
    def n_objects(self):
        return self._state.n_alive

    @property
    def objects(self):
        return _TracedObjectsProxy()


class _ProbeValue(torch.Tensor):
    """A probe tensor that refuses conversion to a host value, as a JAX
    tracer does: a predicate that branches on it (``and``, ``if``,
    ``float()``) needs host values."""

    def _host(self, *a, **k):
        raise _HostOnlyPredicate("the predicate converts a device value "
                                 "to a host value")

    __bool__ = __float__ = __int__ = __index__ = _host
    item = tolist = numpy = _host


class _ProbeView:
    def __init__(self, sim, dtype):
        def probe(x, dt):
            return torch.tensor(x, dtype=dt).as_subclass(_ProbeValue)

        self.t = probe(0.0, dtype)
        self.dt = probe(1e-3, dtype)
        self.n_objects = probe(1, torch.int32)
        self.objects = _TracedObjectsProxy()
        self.bounds = sim.bounds


def _objects_from_arrays(host: Dict[str, Any], idx) -> List[Object]:
    """Host objects (photons as ``PhotonObject``) for the slots ``idx`` of
    the host planes ``host`` (``r``, ``v``, ``E``, ``otype`` (an array or
    one code); ``dr``, ``dv``, ``a``, ``w`` and ``extras`` where present),
    values in code units."""
    from physicl_tpu_torch.light import PhotonObject

    def vec(name, i):
        return host[name][:, i] if name in host else [0.0] * 3

    otype = np.broadcast_to(host["otype"], np.shape(host["E"]))
    out: List[Object] = []
    for i in idx:
        cls = PhotonObject if otype[i] == OBJ_PHOTON else Object
        o = cls.__new__(cls)
        o.r = Measurement.from_code(host["r"][:, i], "m**1")
        o.dr = Measurement.from_code(vec("dr", i), "m**1")
        o.v = Measurement.from_code(host["v"][:, i], "m**1 s**-1")
        o.dv = Measurement.from_code(vec("dv", i), "m**1 s**-1")
        o.a = Measurement.from_code(vec("a", i), "m**1 s**-2")
        o.E = Measurement.from_code(float(host["E"][i]), "J**1")
        if "w" in host:
            o.w = float(host["w"][i])
        for name, arr in host.get("extras", {}).items():
            setattr(o, name, arr[..., i] if arr.ndim == 2 else float(arr[i]))
        out.append(o)
    return out


class _PendingPopulation:
    """Pre-run ``sim.objects`` when bulk populations are queued: ``len()``
    covers objects and bulks; iterating or indexing it materializes the
    bulk entries as photon objects (expensive at large N)."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim

    def __len__(self):
        return len(self._sim._pending_objects) + sum(
            int(b["n"]) for b in self._sim._pending_bulk)

    def _materialize(self):
        out = list(self._sim._pending_objects)
        for b in self._sim._pending_bulk:
            host = {k: (b[k].detach().cpu().numpy()
                        if isinstance(b[k], torch.Tensor) else np.asarray(b[k]))
                    for k in ("r", "v", "E", "otype", "w") if k in b}
            out += _objects_from_arrays(host, range(int(b["n"])))
        return out

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]


class _HostObjectsProxy:
    """``sim.objects`` during/after a run, and of a host-exact view:
    ``len()`` is the alive count (``n``, else the last one read back);
    iterating or indexing it materializes host objects from the state."""

    def __init__(self, sim: "Simulation", n: Optional[int] = None):
        self._sim = sim
        self._n = n

    def __len__(self):
        return int(self._sim._host_n_alive if self._n is None else self._n)

    def __iter__(self):
        return iter(self._sim._materialize_objects())

    def __getitem__(self, i):
        return self._sim._materialize_objects()[i]


class _HostView:
    """Host stand-in for the ``Simulation`` in host-exact exit predicates:
    ``t``, ``dt`` and ``n_objects`` are host values; iterating ``objects``
    materializes the alive particles (correct, and slow at large N)."""

    def __init__(self, sim: "Simulation", t: float, dt: float, n_alive: int):
        self._sim = sim
        self.bounds = sim.bounds
        self.t = t
        self.dt = dt
        self.n_objects = n_alive
        self.objects = _HostObjectsProxy(sim, n_alive)


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

    ``mode`` is ``"fused"``, ``"generic"`` (the chunked early-exit loop),
    ``"host-exact"`` (chunk 1, the exit predicate checked on the host every
    iteration) or ``"unsupported"`` (the prover refused on a limit of the
    port's kernel, or the generic tier lacks a step's ``apply``:
    ``start()`` raises). ``refusals`` lists the prover's ``(code,
    detail)``."""

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
        if self.fuse_setting != "auto":
            lines.append(f"fusion not attempted: Simulation(fuse="
                         f"{self.fuse_setting!r})")
        for code, detail in self.refusals:
            lines.append(f"fused pipeline refused [{code}]: {detail}")
        if self.mode == "host-exact":
            lines.append(
                "host-exact mode checks the exit predicate on the host every "
                "iteration; declare intent with Simulation(until_t=...) or "
                "Simulation(exit='extinction'), or restrict the predicate to "
                "sim.t/sim.dt or `len(sim.objects) == 0` to restore chunked "
                "execution")
        lines.extend(self.notes)
        return "\n".join(lines)


class Simulation(threading.Thread):
    """Threaded simulation driver (the JAX package's ``Simulation``).

    ``device`` (default ``"cuda"``) places the state and every launch;
    ``seed`` keys the fused tier's counter hash exactly as in the JAX
    package, so a CPU run reproduces the JAX package's CPU run draw for
    draw, and seeds the generic tier's ``torch.Generator``
    (``sim_state.key``). ``dtype`` is ``torch.float32`` or
    ``torch.float64`` (the latter on the generic tier only). ``fuse="off"``
    runs the generic tier; ``"auto"`` (the default) the fused tier wherever
    its prover accepts the plan, else the generic tier with one
    ``RuntimeWarning`` that names the refusal (``sim.explain_plan()``).
    ``used_fused`` and ``chunk_used`` say which tier ran and at what chunk.

    ``fused_pipeline_depth`` chunks stay in flight beyond the one being
    harvested. ``chunk_log`` collects ``(perf_counter, n_valid, event)`` at
    every harvest; ``event`` is the timed CUDA event recorded after the
    chunk (None on the CPU), so a rate over the dispatch loop can be read
    on the device's clock, where a late harvest does not skew it.

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

    ``sim_state`` is the state of the newest dispatched chunk, a snapshot
    that later chunks do not overwrite; on a CUDA device its values are
    final only once the chunk has run (reads are stream-ordered, so they
    wait for it). Its ``key`` is the run's generator itself, which the
    generic tier keeps advancing: a snapshot shares it.
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
        self.chunk_used: Optional[int] = None
        self._warned_fallback = False
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
        self._objects_cache: Optional[List[Object]] = None
        self._host_t = 0.0
        self._host_dt = 0.0
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
        self._objects_cache = None

    def add_objs(self, objs) -> None:
        for o in objs:
            self.add_obj(o)

    def add_photons(self, bulk: Dict[str, Any]) -> None:
        """Add a bulk population from
        :func:`physicl_tpu_torch.light.generate_photon_state`."""
        if self.running:
            _not_ported("mid-run add_photons (population maintenance)")
        self._pending_bulk.append(bulk)
        self._objects_cache = None

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
        self._objects_cache = None

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

    def _materialize_objects(self) -> List[Object]:
        """Copy the state to the host and rebuild host objects for the
        alive slots (photons as ``PhotonObject``), values in code units."""
        if self._objects_cache is not None:
            return self._objects_cache
        st = self.sim_state
        if st is None:
            return self._pending_objects
        with self._state_lock:
            host = st.to_numpy()
        out = _objects_from_arrays(host, np.nonzero(host["alive"])[0])
        if not self.running:
            self._objects_cache = out
        return out

    # -- planning ------------------------------------------------------------

    def _population_policies(self):
        """``(recycle_ok, emit_per_iter)``: a continuous source (an emitter,
        or a split step, which grows the population) recycles slots unless
        a step needs stable slot ids (a trace's rows are slots); emission
        then stops at capacity. (Shrinking, the JAX package's other
        slot-moving policy, is not ported: ``auto_shrink=True`` is
        refused.)"""
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
        if self.dtype not in (torch.float32, torch.float64):
            _not_ported(f"dtype={self.dtype} (float32 or float64)")
        if self.fuse not in ("auto", "off"):
            raise ValueError(f"fuse must be 'auto' or 'off', got "
                             f"{self.fuse!r}")
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
            seed=self.seed, capacity=cap, dtype=self.dtype)
        self._host_n_alive = n0
        self._initial_count = self._hwm = n0
        self._host_t = self._host_dt = 0.0
        self.sim_state = state
        return state

    def _probe_exit_traceable(self, state: SimState) -> bool:
        """True iff the exit predicate evaluates on device values without
        converting one to a host value (the JAX package's trace test)."""
        try:
            torch.as_tensor(self.exit(_ProbeView(self, state.t.dtype)))
            return True
        except Exception:
            return False

    def _exit_traced_fn(self, state: SimState):
        """``(fn, tier)``: the device-evaluated exit predicate for the
        generic tier, or ``(None, "host-exact")``. Tiers, cheapest first: a
        declared intent (``until_t=`` / ``exit="extinction"``) or a
        predicate that evaluates on device values; else one that behaves as
        'no objects left' on sampled host views (``lambda x:
        len(x.objects) == 0``) becomes ``n_alive == 0`` on the device; else
        host-exact (chunk 1)."""
        if getattr(self.exit, "exit_mode_hint", None) == "n0":
            return (lambda view: view.n_objects == 0), "declared-extinction"
        if self._probe_exit_traceable(state):
            tier = ("declared-t-only"
                    if getattr(self.exit, "exit_mode_hint", None) == "t"
                    else "traced")
            return (lambda view: self.exit(view)), tier
        from physicl_tpu_torch.ops.pipeline import _probe_extinction

        if _probe_extinction(self.exit):
            return (lambda view: view.n_objects == 0), "extinction-probe"
        return None, "host-exact"

    def _run_iteration(self, steps, state: SimState,
                       generator: torch.Generator):
        """One generic-tier iteration: every step's ``apply`` in order
        (chunk-boundary steps excepted). Returns ``(state, records)``."""
        ctx = StepContext(generator, self, state.device)
        for step in steps:
            if getattr(step, "at_boundary", False):
                continue  # applied between chunks (PopulationManager)
            state = step.apply(state, ctx)
        return state, ctx.records

    def _auto_chunk(self, steps: List[Step], state: SimState) -> int:
        """Chunk length that keeps one chunk's record buffers under
        ``max_record_bytes`` (at most 1024). The record sizes come from one
        probe iteration on a copy of the run's generator, so the run's own
        stream is untouched."""
        probe = torch.Generator(device=state.device)
        probe.set_state(state.key.get_state())
        _, recs = self._run_iteration(steps, state, probe)
        bytes_per_iter = sum(torch.as_tensor(v).numel()
                             * torch.as_tensor(v).element_size()
                             for v in recs.values())
        if bytes_per_iter == 0:
            return 1024
        return int(np.clip(self.max_record_bytes // bytes_per_iter, 1, 1024))

    def _build_chunk_fn(self, steps: List[Step], exit_fn, chunk: int):
        """The generic tier's chunk: an early-exit loop of at most
        ``chunk`` iterations with the JAX package's ``while_loop``
        semantics. The exit is tested on the pre-iteration state (so no
        iteration ever runs past it), the generator advances only on live
        iterations, and row ``k`` of each record buffer holds iteration
        ``k`` (zeros past the last live one). On a card each test is one
        pinned one-byte copy and an event wait: the device-valued exit
        decides whether the host enqueues the next iteration.

        Returns ``chunk_fn(state) -> (state, done, records, valid)`` with
        ``done`` the exit after the last iteration (a device or host bool)
        and ``valid`` a host bool array."""
        dev_keys = {f"{s._step_uid}/{nm}" for s in steps
                    for nm in getattr(s, "device_records", ())}
        templates: Dict[str, tuple] = {}
        flag = {}

        def exit_now(state):
            if exit_fn is None:
                return False
            return exit_fn(_TracedView(state, self))

        def host_bool(done) -> bool:
            if not isinstance(done, torch.Tensor):
                return bool(done)
            if done.device.type != "cuda":
                return bool(done)
            if "buf" not in flag:
                flag["buf"] = torch.empty((), dtype=torch.bool,
                                          pin_memory=True)
                flag["ev"] = torch.cuda.Event()
            flag["buf"].copy_(done.to(torch.bool), non_blocking=True)
            flag["ev"].record()
            flag["ev"].synchronize()
            return bool(flag["buf"])

        def chunk_fn(state: SimState):
            gen = state.key
            recs: Dict[str, torch.Tensor] = {}
            k = 0
            done = exit_now(state)
            while k < chunk:
                if exit_fn is not None and host_bool(done):
                    break
                state, row = self._run_iteration(steps, state, gen)
                for name, v in row.items():
                    v = torch.as_tensor(v, device=state.device)
                    buf = recs.get(name)
                    if buf is None:
                        buf = recs[name] = torch.zeros(
                            (chunk,) + tuple(v.shape), dtype=v.dtype,
                            device=state.device)
                        templates[name] = (tuple(v.shape), v.dtype)
                    buf[k] = v
                k += 1
                done = exit_now(state)
            for name, (shape, dtype) in templates.items():
                if name not in recs:  # no live iteration in this chunk
                    recs[name] = torch.zeros((chunk,) + shape, dtype=dtype,
                                             device=state.device)
            valid = np.arange(chunk) < k
            return state, done, recs, valid

        chunk_fn.dev_keys = dev_keys
        return chunk_fn

    def _generic_notes(self, boundary: List[str]) -> List[str]:
        notes = [f"device: {self.device}"]
        if boundary:
            notes.append("chunk-boundary population control between chunks: "
                         + ", ".join(boundary))
        notes.append(
            "generic tier: every step's apply as PyTorch tensor ops, one "
            "kernel launch per operation and a device-to-host read of the "
            "exit flag per iteration; make every step fusable (the refusals "
            "above name what blocked it) for the fused_transport kernel")
        return notes

    def _build_execution(self, steps: List[Step], state: SimState,
                         warn: bool = True):
        """Choose the execution strategy: the fused tier when the prover
        accepts the plan, else the generic tier (chunked when the exit
        predicate evaluates on the device or behaves as extinction, chunk 1
        host-exact otherwise). Records the decision in ``plan_report`` and
        warns once when a refusal sends the run to the generic tier. Only
        a prover refusal that the JAX engine shares falls back: a limit of
        the port's kernel raises (``Simulation(fuse="off")`` runs such a
        plan on the generic tier), and an error while building or launching
        a kernel propagates from the dispatch."""
        from physicl_tpu_torch.ops.pipeline import (
            FusedRefusal,
            is_kernel_limit,
            try_build_fused,
        )
        from physicl_tpu_torch.population import ExecPlan

        refusals: List[tuple] = []
        provider = None
        if self.fuse == "auto":
            provider = try_build_fused(self, steps, state, report=refusals)
        boundary = [type(s).__name__ for s in steps
                    if getattr(s, "at_boundary", False)]
        if refusals and is_kernel_limit(refusals[0][0]):
            line = ("a limit of the port's fused_transport kernel, which the "
                    "JAX package's kernel does not have: no fallback to the "
                    "generic tier until the kernel lifts it; "
                    "Simulation(fuse='off') runs the plan there")
            self.plan_report = PlanReport(
                mode="unsupported", chunk=-1, fuse_setting=self.fuse,
                allow_fuse=True, exit_tier="n/a", refusals=refusals,
                notes=[line, "start() raises this refusal"])
            raise FusedRefusal(*refusals[0], missing=line)
        if provider is not None:
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
            if boundary:
                notes.append(
                    "chunk-boundary population control between dispatches: "
                    + ", ".join(boundary) + " (applied once per chunk; "
                    "drains the dispatch pipeline each boundary)")
            self.plan_report = PlanReport(
                mode="fused", chunk=plan.chunk, fuse_setting=self.fuse,
                allow_fuse=True,
                exit_tier=("t-schedule (exit iteration precomputed on host)"
                           if provider.exit_mode == "t"
                           else "extinction (in-kernel alive count)"),
                notes=notes + provider.notes)
            self.chunk_used = plan.chunk
            return ExecPlan(provider=provider, chunk_fn=provider,
                            exit_traced=True, exit_fn=None, chunk=plan.chunk)

        missing = [s for s in steps
                   if not isinstance(s, Step) or s.generic_missing]
        if missing:
            lines = [f"the generic step tier lacks {type(s).__name__}.apply"
                     + (f" ({s.generic_missing})" if isinstance(s, Step)
                        else " (a step of another package)")
                     for s in missing]
            self.plan_report = PlanReport(
                mode="unsupported", chunk=-1, fuse_setting=self.fuse,
                allow_fuse=True, exit_tier="n/a", refusals=refusals,
                notes=lines + ["start() raises: no tier runs this plan"])
            if refusals:
                raise FusedRefusal(*refusals[0], missing="; ".join(lines))
            raise NotImplementedError("; ".join(lines))

        _, emit_per_iter = self._population_policies()
        exit_fn, exit_tier = self._exit_traced_fn(state)
        exit_traced = exit_fn is not None
        # provisional report before any step's apply runs: a step that
        # raises in the probe iteration leaves the refusals readable
        self.plan_report = PlanReport(
            mode="generic", chunk=-1, fuse_setting=self.fuse,
            allow_fuse=True, exit_tier=exit_tier, refusals=refusals,
            notes=["provisional: the generic plan did not finish"])
        # warned before any step's apply runs, so that a step failing on
        # the generic tier still shows why the run went there
        if warn and not self._warned_fallback:
            msg = None
            if not exit_traced:
                msg = (f"host-exact mode (chunk=1): exit predicate "
                       f"{getattr(self.exit, '__name__', repr(self.exit))} "
                       "is neither device-evaluable nor extinction-shaped, "
                       "so it is checked on the host every iteration "
                       "(orders of magnitude slower). Declare intent with "
                       "Simulation(until_t=...) or exit='extinction', or "
                       "restrict it to sim.t/sim.dt or "
                       "`len(sim.objects) == 0`. sim.explain_plan() has the "
                       "full decision.")
            elif refusals:
                code, detail = refusals[0]
                msg = (f"fused pipeline refused [{code}]: {detail} — "
                       "running the generic step tier instead. "
                       "sim.explain_plan() has the full decision.")
            if msg is not None:
                self._warned_fallback = True
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        if not exit_traced:
            # host-exact: the predicate is checked before every iteration
            chunk = 1
        elif self.chunk_steps is not None:
            chunk = int(self.chunk_steps)
        else:
            chunk = self._auto_chunk(steps, state)
        if emit_per_iter:
            # one chunk's emissions must fit in half the arena (slots
            # recycle only at chunk boundaries)
            chunk = max(1, min(chunk,
                               (state.capacity // 2) // emit_per_iter))
        self.chunk_used = chunk
        self.plan_report = PlanReport(
            mode="host-exact" if not exit_traced else "generic",
            chunk=chunk, fuse_setting=self.fuse, allow_fuse=True,
            exit_tier=exit_tier, refusals=refusals,
            notes=self._generic_notes(boundary))
        return ExecPlan(provider=None,
                        chunk_fn=self._build_chunk_fn(steps, exit_fn, chunk),
                        exit_traced=exit_traced, exit_fn=exit_fn,
                        chunk=chunk)

    def explain_plan(self) -> str:
        """Human-readable account of the execution strategy. Callable before
        ``start()`` (plans on a transient state of its own, with its own
        generator, without running) or after."""
        if self.plan_report is None:
            prior = self.sim_state
            try:
                self._check_supported()
                steps = self._ordered_steps()
                state = self._init_run_state()
                for s in steps:
                    s.setup(self)
                self._build_execution(steps, state, warn=False)
            except Exception as e:
                if self.plan_report is None:
                    raise
                # "unsupported" says why no tier runs the plan; otherwise
                # a step failed in the generic probe iteration, and the
                # provisional report keeps the refusals readable
                if self.plan_report.mode != "unsupported":
                    self.plan_report.notes.append(
                        f"the generic tier's probe iteration raised "
                        f"{type(e).__name__}: {e}")
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
        Host records are numpy arrays (the trim is a view); device and
        stream records take the trim as a slice or a bound."""
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
            self._host_t, self._host_dt = stats["t"], stats["dt"]
            self.t = Measurement.from_code(stats["t"], "s**1")
            self.dt = Measurement.from_code(stats["dt"], "s**1")
        self._collect_records(steps, records, n_valid)
        return done, final_state

    def _drive_fused(self, plan, pop, steps, state: SimState) -> SimState:
        """Pipelined dispatch loop: enqueue chunk k+1 before waiting on
        chunk k's records, keeping up to ``fused_pipeline_depth`` chunks in
        flight; returns the definitive final state. Slot recycling and
        chunk-boundary population control need a fresh alive count, so the
        pipeline drains before they run."""
        provider = plan.provider
        depth = max(1, int(self.fused_pipeline_depth))
        if provider.plan.n_stream:
            # each chunk in flight holds up to max_record_bytes of stream
            depth = min(depth, 2)
        pending: deque = deque()

        def drain_one():
            return self._harvest_fused(provider, pending.popleft(), steps)

        while True:
            if pop.needs_attention(state, plan):
                while pending:
                    done, final_state = drain_one()
                    if done:
                        return final_state
                state = pop.maintain(state, plan)
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

    def _fetch(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Device tensors to host numpy arrays in one transfer: pinned
        copies behind one event on a card."""
        if not tensors:
            return {}
        first = next(iter(tensors.values()))
        if first.device.type != "cuda":
            return {k: v.numpy() for k, v in tensors.items()}
        host = {}
        for k, v in tensors.items():
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            host[k] = h
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def _drive_generic(self, plan, pop, steps, state: SimState) -> SimState:
        """The generic tier's chunk loop: host-exact exit checks before
        maintenance (so chunk-boundary population control never runs after
        the final iteration), then maintenance, one chunk, and one batched
        transfer of ``(valid, done, t, dt, n_alive, n_spawned)`` and the
        host records."""
        dev_keys = plan.chunk_fn.dev_keys
        while True:
            if not plan.exit_traced:
                view = _HostView(self, self._host_t, self._host_dt,
                                 self._host_n_alive)
                if bool(self.exit(view)):
                    break
            state = pop.maintain(state, plan)
            state, done, records, valid = plan.chunk_fn(state)
            ready = None
            if state.device.type == "cuda":
                ready = torch.cuda.Event(enable_timing=True)
                ready.record()
            scalars = {"t": state.t, "dt": state.dt,
                       "n": state.n_alive, "hwm": state.n_spawned}
            if isinstance(done, torch.Tensor):
                scalars["done"] = done.to(torch.bool)
            host = self._fetch({**scalars, **{
                k: v for k, v in records.items() if k not in dev_keys}})
            done = bool(host.pop("done", done))
            n_valid = int(valid.sum())
            self.chunk_log.append((time.perf_counter(), n_valid, ready))
            with self._state_lock:
                self.sim_state = state
                self._objects_cache = None
                self._host_t = float(host.pop("t"))
                self._host_dt = float(host.pop("dt"))
                self._host_n_alive = int(host.pop("n"))
                self._hwm = max(self._hwm, int(host.pop("hwm")))
                self.t = Measurement.from_code(self._host_t, "s**1")
                self.dt = Measurement.from_code(self._host_dt, "s**1")
            host.update({k: v for k, v in records.items() if k in dev_keys})
            self._collect_records(steps, host, n_valid)
            if plan.exit_traced and done:
                break
            if not plan.exit_traced and n_valid == 0:
                break
        return state

    def _run_impl(self) -> None:
        from physicl_tpu_torch.population import PopulationManager

        self._check_supported()
        t0 = time.perf_counter()
        self.start_time = time.time()
        self.ts = []
        self.chunk_log = []
        self.population_log = []
        self.running = True
        self._objects_cache = None
        state = self._init_run_state()
        steps = self._ordered_steps()
        for s in steps:
            s.setup(self)
        plan = self._build_execution(steps, state)
        self.used_fused = plan.provider is not None
        pop = PopulationManager(self, steps)
        # chunk-boundary importance snapshots start from the initial
        # positions on both tiers
        pop.prime_boundary_snapshots(state)
        self.setup_seconds = time.perf_counter() - t0
        drive = self._drive_fused if self.used_fused else self._drive_generic
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                drive(plan, pop, steps, state)
        else:
            drive(plan, pop, steps, state)
        with self._state_lock:
            for s in steps:
                s.terminate(self)
            self.run_time = time.time() - self.start_time
            self.running = False
