"""Population control between chunks: slot recycling for continuous
sources and chunk-boundary splitting.

Counterpart of the JAX package's ``population.PopulationManager``:

* recycle: a ``PhotonEmitterStep`` (or a split step, which grows the
  population the same way) allocates slots contiguously from the spawn mark
  and never reuses one, so when the next chunk could run the arena out and
  at least half of the used slots are dead, the survivors are compacted to
  the front and emission continues behind them;
* boundary splits: ``ImportanceSplitStep`` / ``WeightWindowStep`` with
  ``at="chunk"`` apply once per chunk boundary as torch ops, with a
  generator of their own, so the transport itself keeps the fused tier.

Shrink, mid-run injection and removal are not ported (the engine refuses
``auto_shrink=True``, ``add_obj``/``add_photons``/``remove_obj`` during a
run).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from physicl_tpu_torch.ops.compaction import compact
from physicl_tpu_torch.state import SimState

__all__ = ["ExecPlan", "PopulationManager"]

_SPLIT_SEED_SALT = 0x5B1177


@dataclasses.dataclass
class ExecPlan:
    """The execution strategy of a run."""

    provider: Optional[object]   # FusedProvider, or None on the generic tier
    chunk_fn: Callable           # state -> (state, done, records, valid)
    exit_traced: bool            # False => host-exact chunk=1 mode
    exit_fn: Optional[Callable]  # device-evaluated predicate (generic tier)
    chunk: int                   # iterations per dispatch

    def __call__(self, state: SimState):
        """One chunk, dispatched and harvested at once: ``(state, done,
        records, valid)`` on either tier."""
        return self.chunk_fn(state)


class PopulationManager:
    """Applies slot recycling and boundary population control at chunk
    boundaries of a running sim."""

    def __init__(self, sim, steps: List = ()):
        self.sim = sim
        self.recycle_ok, self.emit_per_iter = sim._population_policies()
        self.split_steps = [s for s in steps
                            if getattr(s, "at_boundary", False)
                            and hasattr(s, "boundary_apply")]
        self._split_idx = 0
        # spawn mark at the last arena-pressure boundary where a fresh
        # (post-drain) alive count showed recycling impossible: suppresses
        # repeat drains until the mark moves or the alive mirror drops
        self._recycle_blocked_hwm = None

    def prime_boundary_snapshots(self, state: SimState) -> None:
        """Seed the ``at="chunk"`` importance snapshots from the initial
        positions, before any transport, on both tiers."""
        for s in self.split_steps:
            prime = getattr(s, "prime_snapshot", None)
            if prime is not None:
                prime(state)

    def _reset_split_snapshots(self) -> None:
        """A slot-moving edit (compaction) invalidates every per-slot
        boundary snapshot: drop it, so the next boundary re-snapshots
        instead of comparing moved slots (one boundary of splitting is
        lost)."""
        for s in self.split_steps:
            if getattr(s, "_prev_r", None) is not None:
                s._prev_r = None

    def needs_attention(self, state: SimState, plan: ExecPlan) -> bool:
        """True when recycling or boundary control may be due at this
        boundary; the fused loop then drains its pipeline first, so that
        the alive count is fresh.

        The spawn mark is dispatch-fresh but the alive mirror lags the
        pipeline by the chunks in flight, so pressure is checked one chunk
        early (twice the need), and the first boundary under a given
        pressure always drains and lets :meth:`maintain` judge on fresh
        counts; when that judgement was "too few dead slots", repeat drains
        wait until the spawn mark moves or the mirror drops below half."""
        if self.split_steps:
            return True  # boundary control runs at every boundary
        provider = plan.provider
        if not self.recycle_ok or provider is None:
            return False
        need = self.emit_per_iter * provider.plan.chunk
        if provider.hwm_h + 2 * need > state.capacity:
            if self.sim._host_n_alive < provider.hwm_h // 2:
                return True
            if self._recycle_blocked_hwm != provider.hwm_h:
                return True
        return False

    def maintain(self, state: SimState, plan: ExecPlan) -> SimState:
        """Run every applicable policy at a chunk boundary; returns the
        (possibly new) state."""
        state = self._recycle(state, plan)
        return self._apply_boundary_splits(state, plan)

    def _recycle(self, state: SimState, plan: ExecPlan) -> SimState:
        """Compact when the next chunk could exhaust the arena and fewer
        than half of the used slots are alive."""
        sim = self.sim
        if not self.recycle_ok:
            return state
        provider = plan.provider
        hwm = provider.hwm_h if provider is not None else sim._hwm
        need = self.emit_per_iter * plan.chunk
        if hwm + need <= state.capacity:
            return state
        if sim._host_n_alive >= hwm // 2:
            self._recycle_blocked_hwm = hwm
            return state
        self._recycle_blocked_hwm = None
        self._reset_split_snapshots()
        state = compact(state)
        sim._hwm = sim._host_n_alive
        with sim._state_lock:
            sim.sim_state = state
        if provider is not None:
            provider.resync(state)
            after, chunk_idx = provider.hwm_h, provider.chunk_idx
        else:
            after, chunk_idx = sim._hwm, len(sim.chunk_log)
        sim.population_log.append(("recycle", chunk_idx, hwm, after))
        return state

    def _exit_pending(self, state: SimState, plan: ExecPlan) -> bool:
        """Would the next chunk run no iteration? Then boundary control
        would only alter the final state the user reads."""
        if plan.provider is not None:
            return plan.provider.exit_pending()
        if plan.exit_fn is None:
            return False  # host-exact: the engine checked before maintain
        from physicl_tpu_torch.engine import _TracedView

        return bool(plan.exit_fn(_TracedView(state, self.sim)))

    def _apply_boundary_splits(self, state: SimState,
                               plan: ExecPlan) -> SimState:
        """One boundary op per split step, each with a generator seeded
        from ``(seed ^ 0x5B1177) & 0x7FFFFFFF`` and the boundary op's index
        (separate from the transport's stream), then the alive count and
        spawn mark read back in one transfer."""
        from physicl_tpu_torch.engine import StepContext

        if not self.split_steps or self._exit_pending(state, plan):
            return state
        sim = self.sim
        base = (int(getattr(sim, "seed", 0)) ^ _SPLIT_SEED_SALT) & 0x7FFFFFFF
        before = state
        for s in self.split_steps:
            self._split_idx += 1
            g = torch.Generator(device=state.device)
            g.manual_seed((base << 32) | self._split_idx)
            state = s.boundary_apply(state, StepContext(g, None,
                                                        state.device))
        if state is before:  # e.g. the first boundary's snapshot only
            return state
        with sim._state_lock:
            sim.sim_state = state
        n_h, hwm_h = torch.stack([state.n_alive.to(torch.int64),
                                  state.n_spawned.to(torch.int64)]).tolist()
        sim._host_n_alive = int(n_h)
        sim._hwm = max(sim._hwm, int(hwm_h))
        if plan.provider is not None:
            plan.provider.resync(state, counts=(n_h, hwm_h))
        return state
