"""Slot recycling for continuous sources, between chunk dispatches.

Counterpart of the recycle policy of the JAX package's
``population.PopulationManager``: a ``PhotonEmitterStep`` allocates slots
contiguously from the spawn mark and never reuses one, so when the next
chunk could run the arena out and at least half of the used slots are dead,
the survivors are compacted to the front and emission continues behind
them. Shrink, mid-run injection and removal are not ported (the engine
refuses ``auto_shrink=True``, ``add_obj``/``add_photons``/``remove_obj``
during a run).
"""

from __future__ import annotations

from physicl_tpu_torch.ops.compaction import compact
from physicl_tpu_torch.state import SimState

__all__ = ["PopulationManager"]


class PopulationManager:
    """Applies slot recycling at chunk boundaries of a running sim."""

    def __init__(self, sim):
        self.sim = sim
        self.recycle_ok, self.emit_per_iter = sim._population_policies()
        # spawn mark at the last arena-pressure boundary where a fresh
        # (post-drain) alive count showed recycling impossible: suppresses
        # repeat drains until the mark moves or the alive mirror drops
        self._recycle_blocked_hwm = None

    def needs_attention(self, state: SimState, provider) -> bool:
        """True when recycling may be due at this boundary; the engine then
        drains its pipeline first, so that the alive count is fresh.

        The spawn mark is dispatch-fresh but the alive mirror lags the
        pipeline by the chunks in flight, so pressure is checked one chunk
        early (twice the need), and the first boundary under a given
        pressure always drains and lets :meth:`maintain` judge on fresh
        counts; when that judgement was "too few dead slots", repeat drains
        wait until the spawn mark moves or the mirror drops below half."""
        if not self.recycle_ok:
            return False
        need = self.emit_per_iter * provider.plan.chunk
        if provider.hwm_h + 2 * need > state.capacity:
            if self.sim._host_n_alive < provider.hwm_h // 2:
                return True
            if self._recycle_blocked_hwm != provider.hwm_h:
                return True
        return False

    def maintain(self, state: SimState, provider) -> SimState:
        """Compact when the next chunk could exhaust the arena and fewer
        than half of the used slots are alive; returns the (possibly new)
        state."""
        sim = self.sim
        if not self.recycle_ok:
            return state
        hwm = provider.hwm_h
        need = self.emit_per_iter * provider.plan.chunk
        if hwm + need <= state.capacity:
            return state
        if sim._host_n_alive >= hwm // 2:
            self._recycle_blocked_hwm = hwm
            return state
        self._recycle_blocked_hwm = None
        state = compact(state)
        with sim._state_lock:
            sim.sim_state = state
        provider.resync(state)
        sim.population_log.append(("recycle", provider.chunk_idx, hwm,
                                   provider.hwm_h))
        return state
