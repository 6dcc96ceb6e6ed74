"""Checkpoint and resume, in the JAX package's file format.

Counterpart of ``physicl_tpu/utils/checkpoint.py``: ``save_checkpoint``
writes one ``.npz`` with every per-particle field, the clocks, the spawn
mark, each extras plane as ``extra.<name>`` and a ``__meta__`` JSON string
(``ts``, ``seed``, ``initial_count``, ``key_impl``, ``hwm``);
``Simulation.restore_checkpoint`` resumes a run from it. A file written by
either package loads in the other.

The one field that differs by package is the generator. The JAX package
feeds ``key`` to ``jax.random``, so this package writes there the raw
``uint32[2]`` data of ``jax.random.PRNGKey(seed)`` (``[0, seed mod 2**32]``,
``key_impl`` null), which the JAX package can use, and keeps its own
``torch.Generator`` state under ``torch_generator.<device type>``, a name
the JAX package does not read. On load the generator takes that state when
the file has one for the target device type, else it is seeded from
``meta["seed"]``. The fused tier never reads either: its draws are a
counter hash of the seed and the chunk index, which a resumed run restarts
at 0 in both packages.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from physicl_tpu_torch.state import SimState

__all__ = ["save_checkpoint", "load_checkpoint", "state_from_checkpoint",
           "repad_state"]

_FIELDS = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w", "t", "dt",
           "key", "n_spawned", "t_comp")
_PLANES = ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w")
_GENERATOR = "torch_generator."


def jax_key_data(seed: int) -> np.ndarray:
    """The raw data of ``jax.random.PRNGKey(seed)`` (threefry, 32-bit
    seeds): ``[0, seed mod 2**32]`` as uint32."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def save_checkpoint(sim, path: str) -> None:
    """Snapshot a Simulation (running or finished; before ``start()``, its
    pending population) to ``path`` (.npz). A run's state on a mesh across
    processes is refused (``NotImplementedError``), as the JAX package's
    fetch of it fails there: no process holds the other processes'
    shards."""
    from physicl_tpu_torch.parallel.distributed import mesh_spans_processes

    if (getattr(sim, "_sim_state", None) is not None
            and mesh_spans_processes(getattr(sim, "mesh", None))):
        raise NotImplementedError(
            "save_checkpoint of a run on a mesh that spans processes: the "
            "state's shards live in several processes, and the JAX "
            "package's save (jax.device_get) cannot fetch them either; "
            "save before start(), or from a run on one process")
    state = sim.sim_state
    if state is None:
        state = SimState.from_population(sim._pending_objects,
                                         sim._pending_bulk, device="cpu",
                                         seed=sim.seed, dtype=sim.dtype)
    with sim._state_lock:
        host = state.to_numpy()
        extras = host.pop("extras")
        host["key"] = jax_key_data(sim.seed)
        if state.key is not None:
            host[_GENERATOR + state.key.device.type] = (
                state.key.get_state().numpy())
        for name, arr in extras.items():
            host[f"extra.{name}"] = arr
        meta = {
            "ts": list(map(float, sim.ts)),
            "seed": int(sim.seed),
            "initial_count": int(sim._initial_count),
            "key_impl": None,
            # the spawn mark: slots below it may hold dead-but-used
            # history (injections append past it), and a shrink on restore
            # must not cut into it
            "hwm": int(max(sim._hwm, int(host["n_spawned"]))),
        }
    np.savez_compressed(path, __meta__=json.dumps(meta), **host)


def load_checkpoint(path: str, device="cuda"):
    """``(SimState on device, meta dict)`` from a checkpoint of either
    package, on the card unless ``device`` says otherwise (as
    ``Simulation`` does). A file without ``w`` (written before weighted
    transport) loads with unit weights, one without ``t_comp`` with a zero
    Kahan compensation. The float planes keep the file's dtype."""
    dev = torch.device(device)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        fields = {f: z[f] for f in _FIELDS if f in z.files and f != "key"}
        if "w" not in fields:
            fields["w"] = np.ones(fields["E"].shape, fields["E"].dtype)
        fields["extras"] = {k[len("extra."):]: z[k] for k in z.files
                            if k.startswith("extra.")}
        gen_state = None
        if _GENERATOR + dev.type in z.files:
            gen_state = torch.from_numpy(
                np.array(z[_GENERATOR + dev.type], np.uint8))
    dtype = (torch.float64 if fields["r"].dtype == np.float64
             else torch.float32)
    state = SimState.from_numpy(fields, dev, seed=int(meta.get("seed", 0)),
                                dtype=dtype)
    if gen_state is not None:
        state.key.set_state(gen_state)
    return state, meta


def state_from_checkpoint(path: str, device="cuda") -> SimState:
    return load_checkpoint(path, device)[0]


def repad_state(state: SimState, capacity: int,
                hwm: int | None = None) -> SimState:
    """Re-pad a snapshot's particle axis to ``capacity``. Growth appends
    dead slots (alive False, w 1, zeros elsewhere); a shrink is allowed
    only where it cuts no used slot (nothing alive beyond the cut, and the
    spawn mark ``hwm`` at or below it), else ``ValueError``. Clocks,
    generator and spawn mark ride through untouched."""
    cap0 = state.capacity
    if capacity == cap0:
        return state
    if capacity < cap0:
        tail_alive = bool(state.alive[capacity:].any())
        used = cap0 if hwm is None else int(hwm)
        if tail_alive or used > capacity:
            raise ValueError(
                f"cannot shrink checkpoint capacity {cap0} -> {capacity}: "
                f"{'live particles' if tail_alive else 'used slots'} "
                "beyond the cut (restore onto a larger capacity/mesh, or "
                "pass capacity= explicitly)")
        cut = {f: getattr(state, f)[..., :capacity].contiguous()
               for f in _PLANES}
        cut["extras"] = {k: v[..., :capacity].contiguous()
                         for k, v in state.extras.items()}
        return state.replace(**cut)
    pad = capacity - cap0

    def grow(x: torch.Tensor, fill=0) -> torch.Tensor:
        tail = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=-1)

    out = {f: grow(getattr(state, f)) for f in _PLANES if f != "w"}
    out["w"] = grow(state.w, fill=1.0)
    out["extras"] = {k: grow(v) for k, v in state.extras.items()}
    return state.replace(**out)
