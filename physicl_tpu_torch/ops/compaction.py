"""Particle compaction: survivors to the front of the slot arena.

Counterpart of the JAX package's ``ops/compaction.py`` ``compact`` and
``compact_shrink`` (plain tensor work there too: a cumsum and a scatter, no
hand-written kernel). The engine compacts to recycle the dead slots of a
continuous source's arena, and shrinks the arena when few survive.
"""

from __future__ import annotations

import torch

from physicl_tpu_torch.state import SimState, pad_capacity

__all__ = ["compact", "compact_shrink"]


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
