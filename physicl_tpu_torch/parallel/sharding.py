"""Particle-axis sharding over a 1-D device mesh, in one process.

Counterpart of ``physicl_tpu/parallel/sharding.py``. Particles are
independent, so a run splits its particle axis into contiguous spans, one
per shard; every shard owns its own tensors on its own device, scalars
(clock, spawn mark) are replicated, and only the measurement records cross
shards, through one reduction (:func:`reduce_sum`, the counterpart of
``psum``).

A mesh is an ordered list of ``torch.device``, one per shard, and a device
may appear more than once: eight shards on one card are the counterpart of
the JAX tests' eight virtual CPU devices, and run exactly the code that
eight cards would. Moves go through ``.to(device)``, which is a no-op on
the same device. There is one code path for every layout.

Draws: the fused tier keys shard ``idx``'s counter hash on
``(seed + (idx + 1) * 97003) & 0x7FFFFFFF`` (:func:`shard_seed`, the JAX
package's ``build_sharded_fused``), and its emitter windows shift by ``idx
* local capacity``, so a shard draws exactly what the JAX package's shard
draws. On the generic tier a step that declares itself shard-local
(``Step.mesh_records``) draws from a generator of each shard's own,
seeded the same way, and any other step applies to the gathered global
planes (:func:`sharded_iteration`); the JAX package draws its generic tier
over the global array, so that tier agrees with it statistically.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from physicl_tpu_torch.state import SimState

__all__ = ["PHOTON_AXIS", "Mesh", "ShardedState", "make_mesh", "as_mesh",
           "shard_state", "as_global", "shard_seed", "reduce_sum",
           "combine_records", "sharded_iteration"]

PHOTON_AXIS = "photons"

_PLANES = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w")
_SCALARS = ("t", "dt", "t_comp", "n_spawned")


class Mesh(tuple):
    """A 1-D mesh over the particle axis: the ``torch.device`` of each
    shard, in shard order (a device may repeat)."""

    axis_names = (PHOTON_AXIS,)

    @property
    def size(self) -> int:
        return len(self)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self]})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` shards over ``devices`` (default: every
    CUDA device), in order and cycling where there are more shards than
    devices: ``make_mesh(8, devices=["cuda:0"])`` puts eight shards on one
    card, ``make_mesh(8, devices=["cpu"])`` eight on the CPU. Without
    ``n_devices`` there is one shard per device."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices="
                               "['cpu'] for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be >= 1, got {n}")
    return Mesh(devices[i % len(devices)] for i in range(n))


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a :class:`Mesh` (a list of devices or device names is
    taken as it is, shard for shard)."""
    if isinstance(mesh, Mesh):
        return mesh
    return make_mesh(devices=list(mesh))


def shard_seed(seed: int, idx: int) -> int:
    """Shard ``idx``'s seed: the JAX package's ``(seed + (idx + 1) *
    97003) & 0x7FFFFFFF`` (its int32 wrap keeps the same low 31 bits)."""
    return (int(seed) + (int(idx) + 1) * 97003) & 0x7FFFFFFF


def reduce_sum(values: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The sum of one tensor per shard on ``device``, added in shard
    order: integer rows exactly, float rows in that fixed order. The one
    place where records cross shards (a collective once the shards live in
    several processes)."""
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


class ShardedState:
    """A :class:`~physicl_tpu_torch.state.SimState` split along its
    particle axis: ``shards[i]`` holds the contiguous span ``[i * L, (i +
    1) * L)`` of the global slots on ``mesh[i]``, with its own copy of the
    replicated scalars and its own generator (``key``).

    The replicated scalars (``t``, ``dt``, ``t_comp``, ``n_spawned``, the
    first shard's ``key``), ``capacity`` and ``n_alive`` (summed over the
    shards) are read without a gather; the particle planes (``r``, ...,
    ``extras``) read the global planes, which :meth:`gather` assembles once
    on the first shard's device. ``replace`` takes the replicated scalars
    only: a particle-plane edit is a global one (gather it first)."""

    def __init__(self, shards: Sequence[SimState], mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh
        self._global: Optional[SimState] = None

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def n_alive(self) -> torch.Tensor:
        return reduce_sum([s.n_alive for s in self.shards], self.device)

    @property
    def key(self):
        return self.shards[0].key

    def __getattr__(self, name):
        if name in _SCALARS:
            return getattr(self.shards[0], name)
        if name in _PLANES or name == "extras":
            return getattr(self.gather(), name)
        raise AttributeError(name)

    def replace(self, **kw) -> "ShardedState":
        bad = set(kw) - set(_SCALARS)
        if bad:
            raise TypeError(
                f"ShardedState.replace takes the replicated scalars "
                f"{_SCALARS} only, not {sorted(bad)}: gather the state "
                "(as_global) to edit particle planes")
        return ShardedState(
            [s.replace(**{k: v.to(s.device) for k, v in kw.items()})
             for s in self.shards], self.mesh)

    def gather(self) -> SimState:
        """The global state on the first shard's device (assembled once):
        each plane the concatenation of the shards' spans, the replicated
        scalars and the generator of the first shard."""
        if self._global is None:
            dev = self.device

            def cat(xs):
                return torch.cat([x.to(dev) for x in xs], dim=-1)

            first = self.shards[0]
            self._global = first.replace(
                **{f: cat([getattr(s, f) for s in self.shards])
                   for f in _PLANES},
                extras={k: cat([s.extras[k] for s in self.shards])
                        for k in first.extras})
        return self._global


def shard_state(state: SimState, mesh, keys=None,
                seed: int = 0) -> ShardedState:
    """Split ``state``'s particle axis into ``len(mesh)`` contiguous spans,
    each copied to its shard's device; scalars are replicated. ``keys``
    gives each shard its generator (a run keeps its shards' generators
    across re-splits); without it shard ``idx`` gets a generator seeded
    with ``shard_seed(seed, idx)``. The capacity must divide into the
    shards (the engine pads it to ``pad_capacity(1) * len(mesh)``)."""
    if isinstance(state, ShardedState):
        return state
    mesh = as_mesh(mesh)
    n = len(mesh)
    C = state.capacity
    if C % n:
        raise ValueError(f"capacity {C} not divisible by mesh size {n}")
    L = C // n
    shards = []
    for idx, dev in enumerate(mesh):
        sl = slice(idx * L, (idx + 1) * L)

        def span(x):
            # a copy of its own (contiguous) on the shard's device
            return x[..., sl].to(dev).clone()

        key = (keys[idx] if keys is not None
               else SimState.make_key(shard_seed(seed, idx), dev))
        shards.append(state.replace(
            **{f: span(getattr(state, f)) for f in _PLANES},
            **{f: getattr(state, f).to(dev) for f in _SCALARS},
            extras={k: span(v) for k, v in state.extras.items()},
            key=key))
    return ShardedState(shards, mesh)


def as_global(state):
    """The global :class:`SimState` of a sharded or a plain state."""
    return state.gather() if isinstance(state, ShardedState) else state


def _declared(step, attr: str):
    """``step``'s ``attr`` where the class that defines its ``apply``, or
    a subclass of that class, declares it; else None. A subclass that
    overrides ``apply`` without declaring again inherits no declaration,
    so it runs as an undeclared step."""
    mro = type(step).__mro__
    owner = next((c for c in mro if "apply" in vars(c)), object)
    for c in mro:
        if attr in vars(c):
            return getattr(step, attr) if issubclass(c, owner) else None
    return None


def _rule(step, name: str, rules) -> str:
    """The declared combine rule of a shard-local ``step``'s record
    ``name``: ``rules[name]``, else the rule of its stem (``count0`` ->
    ``count``), else ``rules["*"]``. A record without one raises: shards
    never guess how to combine."""
    rule = (rules.get(name) or rules.get(name.rstrip("0123456789"))
            or rules.get("*"))
    if rule not in ("once", "sum", "cat"):
        raise ValueError(
            f"{type(step).__name__} records {name!r} on a mesh shard with "
            f"no combine rule (mesh_records {rules!r}): declare 'once', "
            "'sum' or 'cat' for it, or drop mesh_records so that the step "
            "applies to the gathered global state")
    return rule


def combine_records(steps, rows: List[Dict[str, torch.Tensor]],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """One iteration's records of every shard, combined on ``device`` by
    each record's declared rule (:func:`_rule`): ``"once"`` takes the
    first shard's (the replicated clock), ``"sum"`` adds them in shard
    order (:func:`reduce_sum`), ``"cat"`` concatenates a per-particle
    channel in global slot order."""
    by_uid = {s._step_uid: s for s in steps}
    out: Dict[str, torch.Tensor] = {}
    for key in rows[0]:
        uid, _, name = key.partition("/")
        step = by_uid[uid]
        rule = _rule(step, name, _declared(step, "mesh_records"))
        vals = [torch.as_tensor(r[key]) for r in rows]
        if rule == "once":
            out[key] = vals[0].to(device)
        elif rule == "cat":
            out[key] = torch.cat([v.to(device) for v in vals], dim=-1)
        else:
            out[key] = reduce_sum(vals, device)
    return out


def sharded_iteration(steps, state: ShardedState, make_ctx):
    """One generic-tier iteration of ``steps`` over a sharded state.
    Returns ``(state, records)``; ``make_ctx(generator, device)`` builds
    each step's context. Each step runs by what its class declares (where
    it defines ``apply``, :func:`_declared`):

    * ``mesh_records = {record: rule}`` (every built-in per-particle step):
      shard-local. It applies on each shard with the shard's generator,
      and its records combine by the declared rules
      (:func:`combine_records`).
    * ``mesh_scalar = True`` (the clock): replicated scalar outputs only.
      It applies once, to the first shard, with the global alive count in
      ``ctx.n_alive``, and the other shards take its ``t``, ``dt`` and
      ``t_comp``.
    * neither (an emitter or a split, which take global slots; a
      whole-state or recording ``KernelStep``; any user step that does not
      declare itself): it applies once to the gathered global state with
      the first shard's generator, as the JAX package applies every step
      to its global arrays, and the state is split again after it (each
      shard keeping its generator) unless the step returned it as it
      was."""
    mesh = state.mesh
    shards = list(state.shards)
    rows: List[Dict[str, torch.Tensor]] = [{} for _ in shards]
    global_recs: Dict[str, torch.Tensor] = {}
    for step in steps:
        if _declared(step, "mesh_scalar"):
            first = shards[0]
            ctx = make_ctx(first.key, first.device)
            ctx.n_alive = reduce_sum([s.n_alive for s in shards],
                                     first.device)
            first = step.apply(first, ctx)
            global_recs.update(ctx.records)
            clock = {f: getattr(first, f) for f in ("t", "dt", "t_comp")}
            shards = [first] + [
                s.replace(**{f: v.to(s.device) for f, v in clock.items()})
                for s in shards[1:]]
        elif _declared(step, "mesh_records") is None:
            g = ShardedState(shards, mesh).gather()
            ctx = make_ctx(g.key, g.device)
            out = step.apply(g, ctx)
            global_recs.update(ctx.records)
            if out is not g:
                shards = list(shard_state(
                    out, mesh, keys=[s.key for s in shards]).shards)
        else:
            for i, st in enumerate(shards):
                ctx = make_ctx(st.key, st.device)
                shards[i] = step.apply(st, ctx)
                rows[i].update(ctx.records)
    recs = combine_records(steps, rows, shards[0].device)
    recs.update(global_recs)
    return ShardedState(shards, mesh), recs
