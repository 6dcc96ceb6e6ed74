"""Custom physics on the particle state: the port's counterpart of
``physicl_tpu/kernels.py``.

* :class:`KernelStep` embeds a ``SimState -> SimState`` map in the
  simulation loop. ``KernelStep(fn, elementwise=True)`` keeps the fused
  tier: the prover records ``fn`` once over the kernel's facade state
  (:func:`physicl_tpu_torch.ops.record.record_kernelstep`) into a program
  the transport kernel runs for every particle. Without
  ``elementwise=True``, or with ``record_fn``, the prover refuses it (codes
  ``unsupported-step`` and ``kernelstep-records``) and the step runs on
  the generic step tier, which calls ``fn`` on the whole state.
* :class:`KernelInput` / :class:`KernelOutput` / :class:`KernelProgram`
  are the declarative bridge of the reference's ``CLInput`` /
  ``CLOutput`` / ``CLProgram``: gather attributes per particle, draw per
  particle, pass constants, filter by type and hand back the selected
  indices, with a kernel body written as a torch function over whole
  planes. ``run()`` evaluates it on the simulation's state as PyTorch
  tensor ops (no hand-written kernel, as in the JAX package) and returns
  numpy arrays.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.engine import Simulation, Step
from physicl_tpu_torch.state import OBJ_PHOTON, SimState

__all__ = ["KernelInput", "KernelOutput", "KernelProgram", "KernelStep"]

_ATTR_RE = re.compile(r"^(?P<name>[A-Za-z_]\w*)(?:\[(?P<idx>\d)\])?$")

_VEC_FIELDS = {"r", "dr", "v", "dv", "a"}
_SCALAR_FIELDS = {"E"}


def _gather(state: SimState, attr: str) -> torch.Tensor:
    """Resolve an ``obj_attr`` spec like ``dr[0]`` or ``E`` against the
    state's planes (an extras plane by its name)."""
    m = _ATTR_RE.match(attr.strip())
    if not m:
        raise ValueError(f"Unsupported obj_attr spec {attr!r}")
    name, idx = m.group("name"), m.group("idx")
    if name in _VEC_FIELDS:
        field = getattr(state, name)
        if idx is None:
            return field  # (3, C)
        return field[int(idx)]
    if name in _SCALAR_FIELDS:
        if idx is not None:
            raise ValueError(f"{name} is scalar per particle")
        return getattr(state, name)
    if name in state.extras:
        return state.extras[name]
    raise ValueError(f"Unknown particle attribute {name!r}")


class KernelInput:
    """Kernel-argument metadata (the constructor of the reference's
    ``CLInput``). ``type``:

    * ``obj`` — gather ``obj_attr`` per particle (e.g. ``"dr[0]"``);
    * ``obj_def`` — a per-particle value: the literal string
      ``"np.random.random()"`` (optionally ``* <expr>``) for a uniform
      draw a slot, or a callable ``f(generator, n) -> (n,) tensor`` that
      draws from the ``torch.Generator`` it is handed;
    * ``const`` — a scalar argument (``const_value``);
    * ``obj_action`` — a particle filter: ``code`` is a callable
      ``f(state) -> bool mask``, or the reference's photon type check
      (any text naming ``PhotonObject``), which keeps photons;
    * ``obj_track`` — after ``run()``, the indices of the selected
      particles as the program's attribute of this name.
    """

    types = ["obj", "obj_def", "obj_action", "obj_track", "const"]

    def __init__(self, **kwargs):
        self.name = kwargs["name"]
        self.type = kwargs["type"]
        self.obj_attr = kwargs.get("obj_attr")
        self.obj_def = kwargs.get("obj_def")
        self.code = kwargs.get("code")
        self.const_value = kwargs.get("const_value")
        self.ctype = kwargs.get("ctype", "double")

    def _sampler(self):
        d = self.obj_def
        if callable(d):
            return d
        text = str(d).strip()
        m = re.match(r"^np\.random\.random\(\)\s*(?:\*\s*(?P<mul>.+))?$",
                     text)
        if m:
            mul = (float(eval(m.group("mul"), {"np": np}, {}))
                   if m.group("mul") else 1.0)
            return lambda gen, n: torch.rand(
                (n,), generator=gen, device=gen.device) * mul
        raise ValueError(
            f"obj_def {d!r} not recognized. The reference's CLProgram "
            "accepted arbitrary host expressions here "
            "(physicl/__init__.py:544-556); migrating users should pass a "
            "callable ``f(generator, n) -> (n,) tensor`` instead — strictly "
            "more general, and it runs batched on device. The literal "
            "string 'np.random.random()' (optionally '* <scale>') is still "
            "accepted for the common uniform-draw case.")


class KernelOutput:
    """Kernel output metadata (the reference's ``CLOutput``): ``ctype``
    ``"double"`` and ``"float"`` give float32, ``"int"`` int32."""

    _CTYPES = {"double": torch.float32, "float": torch.float32,
               "int": torch.int32}

    def __init__(self, **kwargs):
        self.name = kwargs["name"]
        self.ctype = kwargs.get("ctype", "double")

    @property
    def dtype(self):
        return self._CTYPES.get(self.ctype, torch.float32)


class KernelProgram:
    """Declarative particle kernel (the reference's ``CLProgram``).

    ``kernel_fn(**inputs) -> dict`` is the body: it receives one tensor per
    declared input (a ``(C,)`` plane, or ``(3, C)`` for a whole vector, for
    ``obj`` and ``obj_def``; a 0-d float32 tensor for ``const``) and
    ``valid``, the filter mask (alive and every ``obj_action``), and
    returns ``{output_name: tensor}``. ``build_kernel()`` assembles the
    gather -> body pipeline; ``run(state=None)`` evaluates it on ``state``
    (default: the simulation's current state, else its pending population)
    and returns ``{name: numpy array}`` in each output's dtype. The draws
    of each ``run`` come from a ``torch.Generator`` on the state's device,
    seeded from ``sim.seed`` and the run's count.
    """

    def __init__(self, sim: Optional[Simulation], name: str,
                 kernel_fn: Callable[..., Dict[str, torch.Tensor]]):
        self.sim = sim
        self.prog_name = name
        self.kernel_fn = kernel_fn
        self.prep_metadata: List[KernelInput] = []
        self.output_metadata: List[KernelOutput] = []
        self._compiled = None
        self._seed_counter = 0

    def build_kernel(self):
        ins = self.prep_metadata
        outs = self.output_metadata

        def pipeline(state: SimState, gen: torch.Generator):
            mask = state.alive
            for item in ins:
                if item.type == "obj_action":
                    if callable(item.code):
                        mask = mask & item.code(state)
                    elif "PhotonObject" in str(item.code):
                        mask = mask & (state.otype == OBJ_PHOTON)
                    else:
                        raise ValueError(
                            f"obj_action {item.code!r}: pass a callable "
                            "mask fn")
            kwargs: Dict[str, torch.Tensor] = {"valid": mask}
            for item in ins:
                if item.type == "obj":
                    kwargs[item.name] = _gather(state, item.obj_attr)
                elif item.type == "obj_def":
                    kwargs[item.name] = item._sampler()(gen, state.capacity)
                elif item.type == "const":
                    kwargs[item.name] = torch.tensor(
                        float(item.const_value), dtype=torch.float32,
                        device=state.device)
            result = self.kernel_fn(**kwargs)
            return ({o.name: torch.as_tensor(result[o.name], dtype=o.dtype,
                                             device=state.device)
                     for o in outs}, mask)

        self._compiled = pipeline
        return self

    def run(self, state: Optional[SimState] = None) -> Dict[str, np.ndarray]:
        if self._compiled is None:
            self.build_kernel()
        if state is None:
            state = self.sim.sim_state
            if state is None:
                state = SimState.from_population(
                    self.sim._pending_objects, self.sim._pending_bulk,
                    device=self.sim.device)
        self._seed_counter += 1
        seed = int(getattr(self.sim, "seed", 0) if self.sim else 0)
        gen = torch.Generator(device=state.device)
        gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | self._seed_counter)
        out, mask = self._compiled(state, gen)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for item in self.prep_metadata:
            if item.type == "obj_track":
                # the particles the kernel selected: alive and passing
                # every obj_action filter
                setattr(self, item.name,
                        torch.nonzero(mask).flatten().cpu().numpy())
        return host


class KernelStep(Step):
    """Embed a custom per-particle map in the simulation loop.

    ``fn(state, ctx) -> state``. ``elementwise=True`` is the user's
    contract that ``fn`` is a pure per-particle map, which lets the prover
    record it into the fused kernel:

    * no reductions, gathers or cross-particle mixing;
    * only the packed transport fields ``r, dr, v, dv, E, w`` and ``alive``
      (which can only clear); ``state.a`` and ``state.extras`` are refused
      (``kernelstep-state``; use :class:`physicl_tpu_torch.engine.
      ElementwiseStep` with ``extras=`` for extras planes), as are writes to
      them or to ``t``, ``dt``, ``n_spawned``, ``t_comp``
      (``kernelstep-ignored-write``);
    * no ``ctx`` (``kernelstep-ctx``: randomness needs ElementwiseStep's
      ``p.uniform()``, measurement ReduceMeasureStep), and no
      ``record_fn`` (``kernelstep-records``).

    ``state.otype`` reads each particle's species (on a mixed population,
    the packed otype plane). On the generic tier ``fn`` gets the whole
    :class:`~physicl_tpu_torch.state.SimState` and the
    :class:`~physicl_tpu_torch.engine.StepContext` (draws through
    ``ctx.uniform``); ``record_fn(state) -> {name: value}`` adds record
    channels, collected into ``data`` as one dict per iteration. Example,
    an exponential drag::

        def drag(state, ctx):
            return state.replace(v=state.v * (1.0 - 1e-7))

        sim.add_step(3, KernelStep(drag, elementwise=True))
    """

    def __init__(self, fn: Callable[[SimState, object], SimState],
                 record_fn: Optional[Callable[[SimState], Dict]] = None,
                 elementwise: bool = False):
        super().__init__()
        self.fn = fn
        self.record_fn = record_fn
        self.elementwise = bool(elementwise)
        self.data: List = []

    @property
    def mesh_records(self):
        """Shard-local on a mesh (:func:`physicl_tpu_torch.parallel.
        sharding.sharded_iteration`) only as an elementwise map that
        records nothing; a whole-state map, or one whose ``record_fn`` may
        reduce over the particles, applies to the gathered global state."""
        return {} if self.elementwise and self.record_fn is None else None

    def apply(self, state, ctx):
        prev_alive = state.alive
        state = self.fn(state, ctx)
        if self.elementwise:
            # alive only clears, as in the kernel
            state = state.replace(alive=prev_alive & state.alive)
        if self.record_fn is not None:
            for k, v in self.record_fn(state).items():
                ctx.record(self, k, v)
        return state

    def collect(self, sim, records):
        n = len(next(iter(records.values()))) if records else 0
        for i in range(n):
            self.data.append({k: v[i] for k, v in records.items()})
