"""Particle-axis sharding over a 1-D device mesh, in one process or across
several.

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
the same device. There is one code path for every layout. A mesh across
processes (:func:`physicl_tpu_torch.parallel.make_pod_mesh`) also names the
rank that owns each shard; a process holds only its own shards (one
contiguous block), and what crosses shards crosses processes through the
collectives of :mod:`physicl_tpu_torch.parallel.distributed`, in global
shard order, so that every process computes what the one-process mesh
computes, bit for bit.

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
           "shard_state", "split_span", "as_global", "shard_seed",
           "reduce_sum", "combine_records", "sharded_iteration"]

PHOTON_AXIS = "photons"

_PLANES = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w")
_SCALARS = ("t", "dt", "t_comp", "n_spawned")


class Mesh(tuple):
    """A 1-D mesh over the particle axis: the ``torch.device`` of each
    shard, in shard order (a device may repeat). ``owners[i]`` is the rank
    of the process that holds shard ``i`` and ``rank`` this process's (all
    0 in one process); each process's shards are one contiguous block, in
    rank order."""

    axis_names = (PHOTON_AXIS,)

    def __new__(cls, devices, owners=None, rank: int = 0):
        self = super().__new__(cls, devices)
        self.rank = int(rank)
        self.owners = (tuple(int(o) for o in owners) if owners is not None
                       else (self.rank,) * len(self))
        if len(self.owners) != len(self):
            raise ValueError(f"Mesh: {len(self.owners)} owners for "
                             f"{len(self)} shards")
        if list(self.owners) != sorted(self.owners):
            raise ValueError("Mesh: each process's shards must be one "
                             "contiguous block, in rank order; use "
                             "make_pod_mesh()")
        mine = [i for i, o in enumerate(self.owners) if o == self.rank]
        if not mine:
            raise ValueError("mesh contains no local devices")
        self.local = range(mine[0], mine[-1] + 1)
        return self

    @property
    def size(self) -> int:
        return len(self)

    @property
    def spans_processes(self) -> bool:
        """True iff other processes own some of the shards."""
        return any(o != self.rank for o in self.owners)

    @property
    def local_devices(self) -> List[torch.device]:
        """The devices of this process's shards, in shard order."""
        return [self[i] for i in self.local]

    def __repr__(self) -> str:
        if not self.spans_processes:
            return f"Mesh({[str(d) for d in self]})"
        return (f"Mesh({[str(d) for d in self]}, owners={list(self.owners)}"
                f", rank={self.rank})")


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


def _spans(mesh) -> bool:
    return mesh is not None and getattr(mesh, "spans_processes", False)


def _every_shard(values: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every shard's tensor, in shard order, from this process's shards'
    ``values``: one all-gather across the processes of a mesh that spans
    them (each on this process's first device), else ``values``."""
    if not _spans(mesh):
        return list(values)
    from physicl_tpu_torch.parallel.distributed import all_gather_tensors

    return [v for rank in all_gather_tensors(values) for v in rank]


def reduce_sum(values: Sequence[torch.Tensor],
               device: torch.device, mesh=None) -> torch.Tensor:
    """The sum of one tensor per shard on ``device``, added in shard
    order: integer rows exactly, float rows in that fixed order. The one
    place where records cross shards. ``values`` are this process's
    shards'; on a ``mesh`` across processes every shard's row is
    all-gathered first and the rows are added in global shard order, so
    every process holds what the one-process mesh adds, bit for bit (no
    ``all_reduce``, whose order is unspecified)."""
    values = _every_shard([torch.as_tensor(v).to(device) for v in values],
                          mesh)
    total = values[0].to(device)
    for v in values[1:]:
        total = total + v.to(device)
    return total


class ShardedState:
    """A :class:`~physicl_tpu_torch.state.SimState` split along its
    particle axis: ``shards`` holds this process's shards (all of them in
    one process), shard ``i`` of the mesh the contiguous span ``[i * L, (i
    + 1) * L)`` of the global slots on ``mesh[i]``, with its own copy of
    the replicated scalars and its own generator (``key``). ``first`` is
    the global index of ``shards[0]``.

    The replicated scalars (``t``, ``dt``, ``t_comp``, ``n_spawned``, the
    first shard's ``key``) and ``capacity`` are read without a gather;
    ``n_alive`` sums over every shard (a collective across processes); the
    particle planes (``r``, ..., ``extras``) read the global planes, which
    :meth:`gather` assembles once on the first local shard's device.
    ``replace`` takes the replicated scalars only: a particle-plane edit is
    a global one (gather it first)."""

    def __init__(self, shards: Sequence[SimState], mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh
        self._global: Optional[SimState] = None

    @property
    def first(self) -> int:
        return self.mesh.local.start

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.local_capacity * len(self.mesh)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def n_alive(self) -> torch.Tensor:
        return reduce_sum([s.n_alive for s in self.shards], self.device,
                          self.mesh)

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
        """The global state on the first local shard's device (assembled
        once): each plane the concatenation of every shard's span, the
        replicated scalars and the generator of the first local shard.
        Across processes this is one all-gather of the planes, after which
        every process holds the identical global planes (a collective:
        every process gathers at the same point of the run)."""
        if self._global is None:
            dev = self.device
            first = self.shards[0]
            names = list(_PLANES) + [f"extras.{k}" for k in first.extras]

            def plane(s, name):
                if name.startswith("extras."):
                    return s.extras[name[len("extras."):]]
                return getattr(s, name)

            local = [torch.cat([plane(s, n).to(dev) for s in self.shards],
                               dim=-1) for n in names]
            if _spans(self.mesh):
                from physicl_tpu_torch.parallel.distributed import (
                    all_gather_tensors,
                )

                ranks = all_gather_tensors(local)
                local = [torch.cat([r[j] for r in ranks], dim=-1)
                         for j in range(len(names))]
            planes = dict(zip(names, local))
            self._global = first.replace(
                **{f: planes[f] for f in _PLANES},
                extras={k: planes[f"extras.{k}"] for k in first.extras})
        return self._global


def shard_state(state: SimState, mesh, keys=None,
                seed: int = 0) -> ShardedState:
    """Split ``state``'s particle axis into ``len(mesh)`` contiguous spans,
    each copied to its shard's device; scalars are replicated. ``keys``
    gives the shards their generators, in shard order (a run keeps its
    shards' generators across re-splits); without it shard ``idx`` gets a
    generator seeded with ``shard_seed(seed, idx)``. The capacity must
    divide into the shards (the engine pads it to ``pad_capacity(1) *
    len(mesh)``). A mesh across processes routes through
    :func:`physicl_tpu_torch.parallel.distributed.shard_state_multiprocess`
    (each process keeps its own span, with no transfer)."""
    from physicl_tpu_torch.parallel.distributed import (
        mesh_spans_processes,
        shard_state_multiprocess,
    )

    if isinstance(state, ShardedState):
        return state
    mesh = as_mesh(mesh)
    if mesh_spans_processes(mesh):
        return shard_state_multiprocess(state, mesh, keys=keys, seed=seed)
    n = len(mesh)
    C = state.capacity
    if C % n:
        raise ValueError(f"capacity {C} not divisible by mesh size {n}")
    return split_span(state, mesh, 0, C, keys=keys, seed=seed)


def split_span(state: SimState, mesh: Mesh, start: int, size: int,
               keys=None, seed: int = 0) -> ShardedState:
    """This process's shards of ``state``: its span ``[start, start +
    size)`` of the particle axis (every slot in one process) split evenly
    over ``mesh.local``, each a copy of its own on its shard's device, with
    the replicated scalars; ``keys`` or ``shard_seed(seed, idx)`` give the
    shards their generators (:func:`shard_state`)."""
    L = size // len(mesh.local)
    shards = []
    for j, idx in enumerate(mesh.local):
        dev = mesh[idx]
        sl = slice(start + j * L, start + (j + 1) * L)

        def span(x):
            # a copy of its own (contiguous) on the shard's device
            return x[..., sl].to(dev).clone()

        key = (keys[j] if keys is not None
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
    if rule not in ("once", "sum", "cat", "local"):
        raise ValueError(
            f"{type(step).__name__} records {name!r} on a mesh shard with "
            f"no combine rule (mesh_records {rules!r}): declare 'once', "
            "'sum', 'cat' or 'local' for it, or drop mesh_records so that "
            "the step applies to the gathered global state")
    return rule


def combine_records(steps, rows: List[Dict[str, torch.Tensor]],
                    device: torch.device, mesh=None
                    ) -> Dict[str, torch.Tensor]:
    """One iteration's records of this process's shards, combined on
    ``device`` by each record's declared rule (:func:`_rule`): ``"once"``
    takes shard 0's (the replicated clock), ``"sum"`` adds every shard's
    in shard order (:func:`reduce_sum`), ``"cat"`` concatenates a
    per-particle channel in global slot order, and ``"local"`` concatenates
    this process's shards' spans only (a channel too large to cross
    processes: a trace's positions). On a ``mesh`` across processes the
    ``"once"`` and ``"sum"`` rows of every shard cross in one all-gather
    and each ``"cat"`` channel through :func:`physicl_tpu_torch.parallel.
    distributed.fetch_to_every_host`, so every process holds the
    one-process mesh's records."""
    by_uid = {s._step_uid: s for s in steps}
    rules = {}
    for key in rows[0]:
        uid, _, name = key.partition("/")
        step = by_uid[uid]
        rules[key] = _rule(step, name, _declared(step, "mesh_records"))
    cross = [k for k, r in rules.items() if r in ("once", "sum")]
    every = {k: [torch.as_tensor(r[k]).to(device) for r in rows]
             for k in rules}
    if _spans(mesh) and cross:
        from physicl_tpu_torch.parallel.distributed import all_gather_tensors

        ranks = all_gather_tensors([v for k in cross for v in every[k]])
        n = len(rows)
        for j, k in enumerate(cross):
            every[k] = [r[j * n + i] for r in ranks for i in range(n)]
    out: Dict[str, torch.Tensor] = {}
    for key, rule in rules.items():
        vals = every[key]
        if rule == "once":
            out[key] = vals[0]
        elif rule in ("cat", "local"):
            out[key] = torch.cat(vals, dim=-1)
            if rule == "cat" and _spans(mesh):
                from physicl_tpu_torch.parallel.distributed import (
                    fetch_to_every_host,
                )

                out[key] = torch.from_numpy(
                    fetch_to_every_host(out[key], mesh)).to(device)
        else:
            out[key] = reduce_sum(vals, device)
    return out


def _shard0_generator(shards, mesh, device) -> torch.Generator:
    """Shard 0's generator on every process: its own on shard 0's owner;
    elsewhere a generator on ``device`` that takes the owner's state (one
    broadcast), so that a step on the gathered planes draws on every
    process what the one-process mesh draws. The owner's generator is the
    one that advances; the copies are dropped after the step."""
    if not _spans(mesh):
        return shards[0].key
    from physicl_tpu_torch.parallel.distributed import broadcast_tensors

    owner = mesh.rank == mesh.owners[0]
    gen = shards[0].key if owner else torch.Generator(device=device)
    (st,) = broadcast_tensors([gen.get_state()], src=mesh.owners[0])
    if not owner:
        gen.set_state(st)
    return gen


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
      It applies once, to shard 0, with the global alive count in
      ``ctx.n_alive``, and the other shards take its ``t``, ``dt`` and
      ``t_comp`` (across processes, with its records, from shard 0's
      owner in one broadcast; the other processes apply it to a copy of
      their first shard's generator, which shapes what they receive).
    * neither (an emitter or a split, which take global slots; a
      whole-state or recording ``KernelStep``; any user step that does not
      declare itself): it applies once to the gathered global state with
      shard 0's generator (across processes, every process applies it,
      with that generator's state broadcast from its owner), as the JAX
      package applies every step to its global arrays, and the state is
      split again after it (each shard keeping its generator) unless the
      step returned it as it was."""
    mesh = state.mesh
    spans = _spans(mesh)
    shards = list(state.shards)
    rows: List[Dict[str, torch.Tensor]] = [{} for _ in shards]
    global_recs: Dict[str, torch.Tensor] = {}
    for step in steps:
        if _declared(step, "mesh_scalar"):
            first = shards[0]
            owner = not spans or mesh.rank == mesh.owners[0]
            gen = first.key
            if not owner:
                gen = torch.Generator(device=first.device)
                gen.set_state(first.key.get_state())
            ctx = make_ctx(gen, first.device)
            ctx.n_alive = reduce_sum([s.n_alive for s in shards],
                                     first.device, mesh)
            out = step.apply(first, ctx)
            clock = {f: getattr(out, f) for f in ("t", "dt", "t_comp")}
            recs = {k: torch.as_tensor(v, device=first.device)
                    for k, v in ctx.records.items()}
            if spans:
                from physicl_tpu_torch.parallel.distributed import (
                    broadcast_tensors,
                )

                names = sorted(recs)
                vals = broadcast_tensors(
                    [clock[f] for f in ("t", "dt", "t_comp")]
                    + [recs[k] for k in names], src=mesh.owners[0])
                clock = dict(zip(("t", "dt", "t_comp"), vals[:3]))
                recs = dict(zip(names, vals[3:]))
            global_recs.update(recs)
            shards = [out if owner else first.replace(**clock)] + [
                s.replace(**{f: v.to(s.device) for f, v in clock.items()})
                for s in shards[1:]]
        elif _declared(step, "mesh_records") is None:
            g = ShardedState(shards, mesh).gather()
            ctx = make_ctx(_shard0_generator(shards, mesh, g.device),
                           g.device)
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
    recs = combine_records(steps, rows, shards[0].device, mesh)
    recs.update(global_recs)
    return ShardedState(shards, mesh), recs
