"""Particle compaction: survivors to the front of the slot arena.

Counterpart of the JAX package's ``ops/compaction.py:compact`` (plain tensor
work there too: a cumsum and a scatter, no hand-written kernel). The engine
compacts to recycle the dead slots of a continuous source's arena.
"""

from __future__ import annotations

import torch

from physicl_tpu_torch.state import SimState

__all__ = ["compact"]


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
