"""Particle compaction: survivors to the front of the slot arena.

Counterpart of the JAX package's ``ops/compaction.py`` ``compact``,
``compact_shrink`` and ``make_spatial_sort`` (plain tensor work there too:
a cumsum and a scatter, an argsort and a gather, no hand-written kernel).
The engine compacts to recycle the dead slots of a continuous source's
arena, shrinks the arena when few survive, and with
``Simulation(spatial_sort=K)`` reorders the population by voxel.
"""

from __future__ import annotations

import torch

from physicl_tpu_torch.state import SimState, pad_capacity

__all__ = ["compact", "compact_shrink", "make_spatial_sort",
           "permute_state"]


def compact(state: SimState) -> SimState:
    """Stable partition of every per-slot plane: alive particles move to
    the front in slot order, dead ones behind them in slot order; the spawn
    mark becomes the alive count. Returns a new state (the input is not
    modified)."""
    alive_i = state.alive.to(torch.int64)
    dead_i = 1 - alive_i
    n_alive = alive_i.sum()
    rank_alive = torch.cumsum(alive_i, 0) - alive_i
    rank_dead = torch.cumsum(dead_i, 0) - dead_i
    dest = torch.where(state.alive, rank_alive, n_alive + rank_dead)
    C = state.capacity

    def scatter_last(x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 0 or x.shape[-1] != C:
            return x
        out = torch.zeros_like(x)
        out[..., dest] = x
        return out

    return state.replace(
        r=scatter_last(state.r), dr=scatter_last(state.dr),
        v=scatter_last(state.v), dv=scatter_last(state.dv),
        a=scatter_last(state.a), E=scatter_last(state.E),
        alive=scatter_last(state.alive), otype=scatter_last(state.otype),
        w=scatter_last(state.w),
        n_spawned=n_alive.to(torch.int32),
        extras={k: scatter_last(v) for k, v in state.extras.items()},
    )


def compact_shrink(state: SimState, n_alive: int) -> SimState:
    """Compact, then cut the capacity to the padded survivor count
    (``pad_capacity(n_alive)``, a host-side decision: the capacity is a
    shape). Returns ``state`` itself where no shrink is possible."""
    new_cap = pad_capacity(max(int(n_alive), 1))
    if new_cap >= state.capacity:
        return state
    packed = compact(state)
    C = state.capacity

    def cut(x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 0 or x.shape[-1] != C:
            return x
        return x[..., :new_cap].contiguous()

    return packed.replace(
        r=cut(packed.r), dr=cut(packed.dr), v=cut(packed.v),
        dv=cut(packed.dv), a=cut(packed.a), E=cut(packed.E),
        alive=cut(packed.alive), otype=cut(packed.otype), w=cut(packed.w),
        extras={k: cut(v) for k, v in packed.extras.items()},
    )


_SPAWNED_DEAD = 2 ** 31 - 2  # the sort key of a dead slot below the mark
_FREE_TAIL = 2 ** 31 - 1     # the sort key of a never-spawned slot


def make_spatial_sort(spec: dict):
    """``state -> state``: reorder the population by the flat (x-major)
    index of each particle's nearest voxel under a
    :func:`physicl_tpu_torch.light.voxel_density` grid ``spec`` (its
    ``shape``, ``origin`` and ``spacing``), the JAX package's
    single-device ``make_spatial_sort``.

    The key is ``(ix * ny + iy) * nz + iz`` with each index
    ``round((r - origin) / spacing)`` (half to even) clipped into the grid,
    so a particle outside it sorts with the nearest edge voxel. Dead slots
    below the spawn mark key ``2**31 - 2`` and the never-spawned tail
    ``2**31 - 1``, and the argsort is stable: alive particles come first in
    voxel order, the spawned dead behind them, and the free tail keeps its
    order at the back, so ``n_spawned`` is untouched. Every particle-axis
    plane and every extras plane moves under the one permutation (a gather
    a plane). Slot identity is not kept, so the fused tier's per-slot
    draws reassign with the move. ``sort.permutation(state)`` gives the
    permutation alone, for a caller that moves the planes itself."""
    nx, ny, nz = (int(d) for d in spec["shape"])
    ox, oy, oz = (float(v) for v in spec["origin"])
    sx, sy, sz = (float(v) for v in spec["spacing"])

    def index(x, o, s, n):
        return torch.clamp(torch.round((x - o) / s).to(torch.int32), 0,
                           n - 1)

    def permutation(state: SimState) -> torch.Tensor:
        C = state.capacity
        r = state.r
        flat = ((index(r[0], ox, sx, nx) * ny + index(r[1], oy, sy, ny))
                * nz + index(r[2], oz, sz, nz))
        slots = torch.arange(C, dtype=torch.int32, device=state.device)
        dead = torch.where(slots < state.n_spawned, _SPAWNED_DEAD,
                           _FREE_TAIL).to(torch.int32)
        key = torch.where(state.alive, flat, dead)
        return torch.argsort(key, stable=True)

    def sort(state: SimState) -> SimState:
        return permute_state(state, permutation(state))

    sort.permutation = permutation
    return sort


def take_slots(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x`` gathered along its particle (last) axis by ``perm``; a tensor
    without that axis as it is."""
    if x.ndim == 0 or x.shape[-1] != perm.shape[0]:
        return x
    return x.index_select(x.ndim - 1, perm)


def permute_state(state: SimState, perm: torch.Tensor) -> SimState:
    """Every particle-axis plane and every extras plane of ``state``
    gathered by ``perm``; clocks and the spawn mark as they are."""
    return state.replace(
        **{f: take_slots(getattr(state, f), perm)
           for f in ("r", "dr", "v", "dv", "a", "E", "alive", "otype", "w")},
        extras={k: take_slots(v, perm) for k, v in state.extras.items()})
