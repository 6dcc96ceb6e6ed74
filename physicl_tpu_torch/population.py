"""Population control between chunks: slot recycling for continuous
sources, shrinking, mid-run edits and chunk-boundary splitting.

Counterpart of the JAX package's ``population.PopulationManager``:

* recycle: a ``PhotonEmitterStep`` (or a split step, which grows the
  population the same way) allocates slots contiguously from the spawn mark
  and never reuses one, so when the next chunk could run the arena out and
  at least half of the used slots are dead, the survivors are compacted to
  the front and emission continues behind them;
* shrink (``Simulation(auto_shrink=True)``, the default): when fewer than
  a quarter of the slots are alive, the survivors are compacted and the
  capacity cut to their padded count, so the remaining chunks launch over
  fewer lanes;
* remove: a mid-run ``remove_obj`` clears its queued slot's alive flag;
* inject: a mid-run ``add_obj`` / ``add_photons`` writes the queued
  particles into fresh slots from the spawn mark, growing the capacity
  where they do not fit, and keeps the fused plan, re-proves it (a grown
  capacity under a stream or emitter plan, whose chunk depends on it) or
  falls back to the generic tier for the rest of the run (particles that
  break the plan's invariants);
* boundary splits: ``ImportanceSplitStep`` / ``WeightWindowStep`` with
  ``at="chunk"`` apply once per chunk boundary as torch ops, with a
  generator of their own, so the transport itself keeps the fused tier.

Every slot-moving edit (compaction, shrink, injection, the engine's
spatial sort) drops the ``at="chunk"`` split snapshots. On a device mesh
every edit acts on the global planes (gathered from the shards; the next
chunk splits them again), so a recycling compaction moves live particles
across shards exactly as the single-device compaction moves them, and a
split's copies take global free slots. On a mesh across processes the
gather is an all-gather, after which every process holds the identical
global planes and takes the same decision from the same inputs (the alive
count and spawn mark of the records, which every process reads alike), as
the JAX package's ``compact_on_mesh`` does; each process then keeps its
span. Mid-run edits are queued per process, so there the divergence guard
(:meth:`PopulationManager.check_divergence`) releases only the edits that
every process has queued alike, at the same boundary everywhere.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.ops.compaction import compact, compact_shrink
from physicl_tpu_torch.parallel.sharding import as_global
from physicl_tpu_torch.state import SimState, pad_capacity

__all__ = ["ExecPlan", "PopulationManager"]

_SPLIT_SEED_SALT = 0x5B1177

# Edits per boundary considered for cross-process prefix consensus (the
# all-gathered row stays fixed-size: 3 + 2*K u64s). A backlog deeper than K
# simply consents over several boundaries.
_GUARD_WINDOW = 16


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
        self.steps = list(steps)
        self.shrink_ok, self.recycle_ok, self.emit_per_iter = (
            sim._population_policies())
        self.split_steps = [s for s in steps
                            if getattr(s, "at_boundary", False)
                            and hasattr(s, "boundary_apply")]
        self._split_idx = 0
        # spawn mark at the last arena-pressure boundary where a fresh
        # (post-drain) alive count showed recycling impossible: suppresses
        # repeat drains until the mark moves or the alive mirror drops
        self._recycle_blocked_hwm = None
        # SPMD divergence guard (meshes across processes): population
        # edits must apply identically on every process. Each chunk
        # boundary all-gathers prefix digests of the queued edits and
        # releases only the prefix EVERY process has queued alike
        # (consensus gating): an identical edit issued at different times
        # is deferred a boundary, not fatal. Divergence raises on every
        # process: at once for a same-position mismatch, after
        # divergence_patience stalled boundaries for an edit queued on some
        # processes only (opt out: Simulation(divergence_guard=False))
        from physicl_tpu_torch.parallel.distributed import (
            mesh_spans_processes,
        )

        self.spmd_guard = (mesh_spans_processes(sim.mesh)
                           and getattr(sim, "divergence_guard", True))
        self._boundary_idx = 0
        # (injects, removes) released for application at this boundary by
        # the consensus round; _apply_* consume their component
        self._consensus = (0, 0)
        self._stall_rounds = 0
        self._patience = int(getattr(sim, "divergence_patience", 256))
        # cumulative digest of the edits maintain() applied: consensus
        # gating keeps it identical on every process
        self._applied_h = hashlib.blake2b(digest_size=8)

    def prime_boundary_snapshots(self, state: SimState) -> None:
        """Seed the ``at="chunk"`` importance snapshots from the initial
        positions, before any transport, on both tiers."""
        for s in self.split_steps:
            prime = getattr(s, "prime_snapshot", None)
            if prime is not None:
                prime(state)

    def _reset_split_snapshots(self) -> None:
        """A slot-moving edit (compaction, shrink, injection, a spatial
        sort) invalidates every per-slot boundary snapshot: drop it, so the
        next boundary re-snapshots instead of comparing moved slots (one
        boundary of splitting is lost)."""
        for s in self.split_steps:
            if getattr(s, "_prev_r", None) is not None:
                s._prev_r = None

    # -- the divergence guard (meshes across processes) -----------------------

    @staticmethod
    def _hash_edits(h, items, removes) -> None:
        """Fold population edits (order, kinds, payload values) into digest
        ``h``: the JAX package's fields, as float64 bytes. Identical edit
        sequences give identical digests."""
        from physicl_tpu_torch.units import raw_code_value

        def f64(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return np.ascontiguousarray(np.asarray(x, np.float64)).tobytes()

        h.update(np.int64(len(items)).tobytes())
        for kind, payload in items:
            h.update(kind.encode())
            if kind == "bulk":
                h.update(np.int64(int(payload["n"])).tobytes())
                h.update(np.int64(int(payload["otype"])).tobytes())
                for f in ("r", "v", "E"):
                    h.update(f64(payload[f]))
                if "w" in payload:  # statistical weights (presence hashes)
                    h.update(b"w" + f64(payload["w"]))
            else:  # "obj"
                h.update(np.int64(getattr(payload, "_obj_type_code",
                                          0)).tobytes())
                for f in ("r", "v", "E"):
                    h.update(f64(raw_code_value(getattr(payload, f, 0.0))))
                h.update(f64(raw_code_value(getattr(payload, "w", 1.0))))
        h.update(np.asarray(sorted(removes), np.int64).tobytes())

    def _note_applied(self, items, removes) -> None:
        if self.spmd_guard and (items or removes):
            self._hash_edits(self._applied_h, items, removes)

    def _allgather_row(self, row: np.ndarray) -> np.ndarray:
        """``row`` (uint64) of every process, one per rank, through one
        all-gather of its int64 view."""
        from physicl_tpu_torch.parallel.distributed import all_gather_tensors

        t = torch.from_numpy(row.view(np.int64).copy())
        return np.stack([r.numpy().view(np.uint64)
                         for (r,) in all_gather_tensors([t])])

    def check_divergence(self) -> None:
        """Consensus-gate queued population edits across processes.

        Called once per chunk boundary on EVERY process (the run threads
        reach boundaries in lockstep, so the collective always pairs).
        All-gathers the applied-history digest plus per-position prefix
        digests of the locally queued edits, then releases for application
        only the prefix every process has queued identically
        (``self._consensus``); the rest stay queued for a later boundary.
        An identical edit issued at different times (one process's run
        crossing the boundary a beat before another's enqueue) is deferred
        to the boundary where every process has it, so the edit, and any
        capacity growth or re-plan it brings, lands at one boundary on
        every process. Divergence raises ``RuntimeError`` on every process:
        at once when the same queue position holds different edits or the
        applied histories differ; after ``Simulation(divergence_patience=
        ...)`` (default 256) consecutive stalled boundaries when an edit
        was issued on some processes only.
        """
        if not self.spmd_guard:
            return
        self._boundary_idx += 1
        sim = self.sim
        with sim._inject_lock:
            items = list(sim._pending_inject)
            removes = list(sim._pending_remove)
        K = _GUARD_WINDOW
        inj_pref = []
        h = hashlib.blake2b(digest_size=8)
        for it in items[:K]:
            self._hash_edits(h, [it], [])
            inj_pref.append(int.from_bytes(h.copy().digest(), "little"))
        rem_pref = []
        h = hashlib.blake2b(digest_size=8)
        for slot in removes[:K]:
            h.update(np.int64(slot).tobytes())
            rem_pref.append(int.from_bytes(h.copy().digest(), "little"))
        row = np.zeros(3 + 2 * K, np.uint64)
        row[0] = int.from_bytes(self._applied_h.copy().digest(), "little")
        row[1], row[2] = len(inj_pref), len(rem_pref)
        row[3:3 + len(inj_pref)] = inj_pref
        row[3 + K:3 + K + len(rem_pref)] = rem_pref
        g = self._allgather_row(row)
        if not (g[:, 0] == g[0, 0]).all():
            raise RuntimeError(
                f"multi-host SPMD divergence at chunk boundary "
                f"{self._boundary_idx}: applied population-edit histories "
                f"differ across processes (digests "
                f"{[hex(int(x)) for x in g[:, 0]]}); device state is no "
                f"longer consistent.")
        m_inj = int(g[:, 1].min())
        m_rem = int(g[:, 2].min())
        # prefix digests are cumulative: position m-1 equal => whole prefix
        # equal. A mismatch there is the same queue position holding
        # DIFFERENT edits on different processes: divergence.
        if m_inj and not (g[:, 2 + m_inj] == g[0, 2 + m_inj]).all():
            raise RuntimeError(
                f"multi-host SPMD divergence at chunk boundary "
                f"{self._boundary_idx}: the first {m_inj} queued "
                f"injection(s) differ across processes (prefix digests "
                f"{[hex(int(x)) for x in g[:, 2 + m_inj]]}). Mid-run "
                f"add_obj / add_photons must be issued identically and in "
                f"the same order on every process.")
        if m_rem and not (g[:, 2 + K + m_rem] == g[0, 2 + K + m_rem]).all():
            raise RuntimeError(
                f"multi-host SPMD divergence at chunk boundary "
                f"{self._boundary_idx}: the first {m_rem} queued "
                f"removal(s) differ across processes. Mid-run remove_obj "
                f"must be issued identically and in the same order on "
                f"every process.")
        self._consensus = (m_inj, m_rem)
        stalled = ((m_inj == 0 and int(g[:, 1].max()) > 0)
                   or (m_rem == 0 and int(g[:, 2].max()) > 0))
        self._stall_rounds = self._stall_rounds + 1 if stalled else 0
        if self._stall_rounds >= self._patience:
            counts = [(int(r[1]), int(r[2])) for r in g]
            raise RuntimeError(
                f"multi-host SPMD divergence: population edits queued on "
                f"some processes never appeared on all of them within "
                f"{self._patience} chunk boundaries (queued (inject, "
                f"remove) counts per process: {counts}, boundary "
                f"{self._boundary_idx}). Mid-run add_obj / add_photons / "
                f"remove_obj must be issued on EVERY process.")

    def _pending_injections(self) -> int:
        """Injections this boundary applies: the consensus count under the
        guard (identical on every process), else the local queue's."""
        return (self._consensus[0] if self.spmd_guard
                else len(self.sim._pending_inject))

    def _take(self, queue: str, which: int) -> list:
        """Dequeue the edits this boundary applies: under the guard the
        consensus prefix (consumed: a second apply without a fresh round
        releases none), else the whole queue."""
        sim = self.sim
        with sim._inject_lock:
            pending = getattr(sim, queue)
            if not self.spmd_guard:
                setattr(sim, queue, [])
                return pending
            m = self._consensus[which]
            c = list(self._consensus)
            c[which] = 0
            self._consensus = tuple(c)
            setattr(sim, queue, pending[m:])
            return pending[:m]

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
        sim = self.sim
        if self.spmd_guard:
            # the consensus counts are all-gathered, identical everywhere:
            # every process takes the same drain decision (the raw local
            # queues differ for a while across processes)
            if self._consensus != (0, 0):
                return True
        elif sim._pending_inject or sim._pending_remove:
            return True
        if self.split_steps:
            return True  # boundary control runs at every boundary
        # only where compact_shrink would cut the capacity: at the padded
        # minimum the quarter test can hold for good
        if (self.shrink_ok and 0 < sim._host_n_alive < state.capacity // 4
                and pad_capacity(sim._host_n_alive) < state.capacity):
            return True
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
        """Run every applicable policy at a chunk boundary, in the JAX
        package's order; returns the (possibly new) state. ``plan`` is
        updated in place where an injection re-proves it or falls back."""
        state = self._recycle(state, plan)
        state = self._shrink(state, plan)
        state = self._apply_removals(state, plan)
        state = self._apply_injections(state, plan)
        return self._apply_boundary_splits(state, plan)

    def _apply_removals(self, state: SimState,
                        plan: Optional[ExecPlan] = None) -> SimState:
        """Clear the alive flag of every queued ``remove_obj`` slot."""
        sim = self.sim
        if not sim._pending_remove:
            return state
        slots = self._take("_pending_remove", 1)
        if not slots:
            return state
        self._note_applied([], slots)
        state = as_global(state)
        alive = state.alive.clone()
        alive[torch.tensor(slots, dtype=torch.int64,
                           device=state.device)] = False
        state = state.replace(alive=alive)
        with sim._state_lock:
            sim.sim_state = state
            sim._host_n_alive = int(state.n_alive)
        if plan is not None and plan.provider is not None:
            plan.provider.resync(state)
        return state

    def _apply_injections(self, state: SimState, plan: ExecPlan) -> SimState:
        """Write the queued particles into the state
        (``Simulation._inject_into_state``), then: keep the fused plan
        (the provider re-reads clock, counts and capacity at its next
        dispatch), re-prove it where the capacity grew under a stream or
        emitter plan (whose chunk the capacity bounds; the new provider
        continues the chunk index, so its draws do not repeat chunk 0's),
        or go to the generic tier for the rest of the run where the
        particles break the plan's invariants. On the generic tier a grown
        capacity gets a new chunk function."""
        sim = self.sim
        if not sim._pending_inject:
            return state
        items = self._take("_pending_inject", 0)
        if not items:
            return state
        self._note_applied(items, [])
        self._reset_split_snapshots()
        old_cap = state.capacity
        state, k_new = sim._inject_into_state(state, items)
        with sim._state_lock:
            sim.sim_state = state
            sim._host_n_alive += k_new
        provider = plan.provider
        if provider is None:
            if state.capacity != old_cap:
                plan.chunk_fn = sim._build_chunk_fn(self.steps, plan.exit_fn,
                                                    plan.chunk)
            return state
        if not sim._injection_keeps_plan(provider, items):
            new_plan = sim._build_execution(self.steps, state,
                                            allow_fuse=False)
            plan.__dict__.update(new_plan.__dict__)
            sim.used_fused = False
        elif state.capacity != old_cap and (provider.plan.n_stream
                                            or provider.emit_ops):
            new_plan = sim._build_execution(self.steps, state)
            if new_plan.provider is not None:
                new_plan.provider.chunk_idx = provider.chunk_idx
            plan.__dict__.update(new_plan.__dict__)
            sim.used_fused = new_plan.provider is not None
        else:
            provider.invalidate()
        return state

    def _recycle(self, state: SimState, plan: ExecPlan) -> SimState:
        """Compact when the next chunk could exhaust the arena and fewer
        than half of the used slots are alive (not with an injection
        queued: it places its particles itself)."""
        sim = self.sim
        if not self.recycle_ok or self._pending_injections():
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
        state = compact(as_global(state))
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

    def _shrink(self, state: SimState, plan: ExecPlan) -> SimState:
        """Compact and cut the capacity when ``0 < n_alive < capacity //
        4`` (the JAX package's ``PopulationManager._shrink``): never where
        a step needs stable slot ids, a continuous source runs, or the user
        set the capacity (``shrink_ok``), and never with an injection
        queued. The fused provider then plans its next chunk at the new
        capacity; the generic tier gets a new chunk function."""
        sim = self.sim
        n = sim._host_n_alive
        if (not self.shrink_ok or n == 0 or self._pending_injections()
                or n >= state.capacity // 4):
            return state
        new_state = compact_shrink(state, n)
        if new_state.capacity == state.capacity:
            return state
        self._reset_split_snapshots()
        before, state = state.capacity, new_state
        sim._hwm = n  # the survivors are packed at the front
        with sim._state_lock:
            sim.sim_state = state
        if plan.provider is not None:
            plan.provider.invalidate()
            chunk_idx = plan.provider.chunk_idx
        else:
            plan.chunk_fn = sim._build_chunk_fn(self.steps, plan.exit_fn,
                                                plan.chunk)
            chunk_idx = len(sim.chunk_log)
        sim.population_log.append(("shrink", chunk_idx, before,
                                   state.capacity))
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
        state = as_global(state)
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

    def flush_removals(self, state: SimState) -> SimState:
        """Removals queued during the final chunk, applied after the loop.

        Under the guard this runs one final consensus round first (so late
        removals issued on every process still apply), then audits: edits
        issued on SOME processes only were applied nowhere, so the state is
        still identical on every process and that is a ``RuntimeWarning``
        (lost intent, not corrupted physics), while a mismatch of the
        applied histories raises."""
        if not self.spmd_guard:
            return self._apply_removals(state)
        self.check_divergence()
        state = self._apply_removals(state)
        sim = self.sim
        with sim._inject_lock:
            leftover = np.array([len(sim._pending_inject),
                                 len(sim._pending_remove)], np.uint64)
        g = self._allgather_row(leftover)
        if g.sum():
            counts = [(int(r[0]), int(r[1])) for r in g]
            warnings.warn(
                f"multi-host run ended with unapplied population edits "
                f"(queued (inject, remove) counts per process: {counts}): "
                f"issued on some processes only, or too late for the last "
                f"chunk boundary. Applied state is still identical on every "
                f"process; issue mid-run edits on every process before the "
                f"run ends to have them take effect.",
                RuntimeWarning, stacklevel=2)
        return state
