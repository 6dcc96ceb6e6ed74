"""Fused-pipeline provider: proves a step list fusable, then serves engine
chunks from :func:`physicl_tpu_torch.ops.fused.fused_chunk`.

Counterpart of ``physicl_tpu/ops/pipeline.py``. Where the JAX prover
returns ``None``, this prover does too, appending the same kind of ``(code,
detail)`` pair to ``report``; the engine then falls back to the generic
step tier, as the JAX engine does. The port's kernel also has limits the
JAX kernel lacks (:func:`is_kernel_limit`): their refusals never fall back,
and the run stops by name until the kernel lifts the limit.

Fusable here: one ``UpdateTimeStep`` whose dt function reads at most
``(t, dt)``, plus any mix of ``NewtonianKinematicsStep``,
``ScatterDeleteStep`` (density and cross-section fields, implicit capture,
roulette, the exponential transform, fluorescence, deposition tallies),
``ScatterIsotropicStep``, ``ScatterHenyeyGreensteinStep``,
``ScatterRayleighStep``, ``ScatterPhaseFunctionStep`` (a phase table; a
callable inverse CDF is refused) and ``ScatterComptonStep`` (cold or
thermal electrons, the heating tally), each with a density field,
``RefractiveInterfaceStep``, ``AbsorbingBoundaryStep``,
``ReflectingBoundaryStep``,
``PeriodicBoundaryStep``, ``AbsorbingSphereStep``, ``PhotonEmitterStep``
(constant or ``PlanckSampler`` energies), ``ScatterSignMeasureStep``
(counts or weight sums), ``ScatterMeasureStep`` (counts, weight sums,
energy sums or per-photon energy lists), ``SphericalShellMeasureStep`` and
``TracePathMeasureStep`` (strided, bfloat16), ``LorentzForceStep``
(constant E and B, a species-wide or per-particle q/m), the polarized
``ScatterPolarizedRayleighStep``, ``ScatterPolarizedComptonStep`` and
``StokesMeasureStep`` and polarized emitters (Stokes and frame rows as
extras planes the kernel writes back), on a photon, a
generic (charged; no photon steps) or a mixed population (photon ops
gated per particle by a packed otype plane), with a t-only or extinction
exit. Fields are C expressions, layered or voxel media
(:mod:`physicl_tpu_torch.ops.fields`), or torch callables recorded into
expression programs.

User code runs in the kernel too (kernel 1i): ``ElementwiseStep``,
``ReduceMeasureStep`` (and ``light.SpectrumMeasureStep`` /
``MeshTallyStep``) and ``KernelStep(elementwise=True)`` callables are
recorded into register programs (:mod:`physicl_tpu_torch.ops.record`:
jnp's elementwise float32 functions, each as jnp computes it); their
refusals carry the JAX prover's codes (``elementwise-``, ``reduce-``,
``kernelstep-`` + ``not-elementwise``, ``trace``, ...) and the
recorder's limit ``*-op-unsupported`` (an op not yet in its table:
``digamma``, ``special.i0`` / ``i0e`` / ``i1``, ``ndtri``, integer
bitwise and shift ops, float64 casts). A field string takes the
reference's ``eval`` grammar (``ops/fields.py``: ``%``, ``//``, one
comparison, boolean logic, ``True`` / ``False``); what that ``eval``
raises on, the prover raises too. Each plan's programs are compiled into
a library of its own (:mod:`physicl_tpu_torch.ops.codegen`), with no limit
on their length, registers or draws.

Per-photon outputs (trace positions, captured energies) are stream planes
of the chunk's stream buffer; the harvest hands them to their steps as
lazy records (:class:`_TraceRaw`, :class:`_EList`) that honour the engine's
valid-prefix slice without copying the buffer.

The provider serves the engine's pipelined ``dispatch``/``harvest`` pair,
with the JAX package's record layout and host-replayed clock. Every
dispatch writes a fresh packed buffer, so each dispatched ``SimState`` is a
snapshot that later chunks never overwrite (the JAX states are immutable;
the port keeps that, at the cost of one state-sized buffer per chunk in
flight).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops import fused as F
from physicl_tpu_torch.ops.planck import icdf_table
from physicl_tpu_torch.state import OBJ_PHOTON, SimState, is_traced
from physicl_tpu_torch.units import Measurement, raw_code_value

__all__ = ["try_build_fused", "FusedProvider", "FusedRefusal",
           "is_kernel_limit"]

# a block's count tile lives in shared memory: [chunk][n_cols] int32
# (csrc/fused_transport.cu: form_smem_bytes; the float sums go to global
# partials)
_MAX_REC_TILE_BYTES = F.MAX_SMEM_BYTES
_EMIT_INACTIVE = -(2 ** 30)  # far-negative start: the window overlaps nothing
_R = ("r0", "r1", "r2")  # the variables of a density field


# the refusal codes the JAX prover returns too (physicl_tpu/ops/pipeline.py)
# and, for user code, the reasons it prefixes with ``elementwise-``,
# ``reduce-`` or ``kernelstep-``: the JAX engine runs these plans on its
# generic scan, and so does the port's. ``dtype`` (a float64 state) joins
# them: the JAX package's kernel is float32 too, and its float64 runs are
# generic-scan runs.
_JAX_CODES = frozenset({
    "dt-fn-not-t-only", "dtype", "duplicate-update-step", "emitter-sampler",
    "empty-population", "exit-predicate", "extinction-with-emitter",
    "extinction-without-death", "extras-missing", "field-fn-gather",
    "jit-off", "kernelstep-records", "kinematics-acceleration",
    "lorentz-per-particle", "no-update-step", "photon-only-op",
    "polarization-planes", "record-columns", "unsupported-step"})
_JAX_USER_REASONS = frozenset({
    "concrete", "ctx", "ignored-write", "not-elementwise", "probe-error",
    "return", "shape", "state", "trace"})


def is_kernel_limit(code: str) -> bool:
    """True for a refusal code that only the port's kernel has (the JAX
    kernel runs the plan): ``field-expr-unsupported`` (a string construct
    the reference evaluates and the field programs lack: an integer floor
    division by a value that may be 0), ``field-fn-callable`` (a callable
    the recorder cannot take) and ``*-op-unsupported`` (an op outside the
    instruction table: ``special.erfcx`` and the torch-only special
    functions, which jnp lacks; an integer ``//`` by a value that may be
    0; a float32 form in float64). Such a refusal does
    not fall back to the generic tier; ``Simulation(fuse="off")`` asks for
    that tier explicitly."""
    prefix, _, reason = code.partition("-")
    return not (code in _JAX_CODES
                or (prefix in ("elementwise", "reduce", "kernelstep")
                    and reason in _JAX_USER_REASONS))


class FusedRefusal(NotImplementedError):
    """The fused prover's refusal ``(code, detail)``. The engine then runs
    the plan on the generic step tier; it raises this where the refusal is
    a limit of the port's kernel (:func:`is_kernel_limit`) or the generic
    tier lacks a step too (``missing`` names either)."""

    def __init__(self, code: str, detail: str, missing: str = ""):
        super().__init__(f"fused pipeline refused [{code}]: {detail}"
                         + (f"; {missing}" if missing else ""))
        self.code = code
        self.detail = detail


class _TOnly:
    """Host probe view exposing only t/dt; touching anything else raises."""

    def __init__(self, t, dt):
        self.t = t
        self.dt = dt

    def __getattr__(self, name):  # n_objects, objects, bounds, ...
        raise AttributeError(name)


def _probe_t_only(fn) -> bool:
    try:
        for t in (0.0, 1.0, 1e30):
            fn(_TOnly(np.float32(t), np.float32(1e-3)))
        return True
    except Exception:
        return False


class _TN:
    def __init__(self, t, n):
        self.t = t
        self.dt = np.float32(1e-3)
        self.n_objects = n
        self.objects = _Len(n)


class _Len:
    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n


def _probe_extinction(fn) -> bool:
    """True iff fn behaves as 'no objects left' on sampled host views:
    True whenever n == 0, False whenever n > 0, regardless of t."""
    try:
        for t in (0.0, 1e-3, 1e30):
            if not bool(fn(_TN(np.float32(t), 0))):
                return False
            for n in (1, 2, 17, 10_000_000):
                if bool(fn(_TN(np.float32(t), n))):
                    return False
        return True
    except Exception:
        return False


def _as_f(x):
    return float(raw_code_value(x)) if isinstance(x, Measurement) else float(x)


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unharvested chunk: device futures + host schedule."""

    state: SimState          # post-chunk state (its own packed buffer)
    rec: torch.Tensor        # (K, 128) int32 host copy (pinned on CUDA)
    rec_f: Optional[torch.Tensor]  # (K, 128) float32 host copy, if used
    ready: Optional[torch.cuda.Event]  # marks the copies done (None on CPU)
    stream: Optional[torch.Tensor]  # (rows, n_stream, C) stream buffer
    k_act: int
    done_t: bool
    ts: np.ndarray
    ts_before: np.ndarray
    dts_after: np.ndarray
    dts_before: np.ndarray
    comps: np.ndarray
    comps_before: np.ndarray
    t_opt: np.float32
    dt_opt: np.float32
    # on a mesh: rec / rec_f hold this process's shards' rows, (shards,
    # K, cols), which harvest() adds in global shard order (across
    # processes too)
    mesh: object = None


class _StreamHold:
    """One chunk's stream buffer, shared by every trace step's record of
    that chunk: spilling it to host memory (``arr`` reassignment) frees the
    device copy for all of them at once."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr


@dataclasses.dataclass
class _TraceRaw:
    """Lazy trace record: the chunk's whole stream buffer and this step's
    planes; the step slices on the host at assembly time."""

    hold: _StreamHold  # shared (ceil(K / every), n_stream, C) buffer
    p0: int            # positions are planes [p0, p0 + 3)
    scat: bool         # plane p0 + 3 carries scatter-event flags
    every: int = 1     # kernel stream stride: row m is iteration m * every
    n_valid: int = -1  # valid ITERATIONS (-1: untrimmed)
    rows: object = None  # sampled row indices (set by the trace step)

    @property
    def buf(self):
        return self.hold.arr

    def __getitem__(self, sl):
        """The engine's valid-prefix trim (``v[:n_valid]``): records the
        bound instead of slicing the buffer."""
        return dataclasses.replace(self, n_valid=_prefix(
            sl, self.buf.shape[0] * self.every))


_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


@dataclasses.dataclass
class _EList:
    """Lazy per-photon energy capture of one plane: the chunk's stream
    buffer (float32, stride 1) holds E where a photon crossed and NaN
    elsewhere. :meth:`per_iteration` compacts it where it lies."""

    buf: torch.Tensor  # (K, n_stream, C)
    plane: int
    ready: Optional[torch.cuda.Event] = None  # the chunk's completion
    n_valid: int = -1
    mesh: object = None  # the run's mesh: across processes C is this span

    def __getitem__(self, sl):
        """The engine's valid-prefix trim: records the bound."""
        return dataclasses.replace(self, n_valid=_prefix(sl,
                                                         self.buf.shape[0]))

    def per_iteration(self) -> List[np.ndarray]:
        """The crossing photons' energies of each valid iteration, in slot
        order (row-major over (iteration, slot), as the JAX lists are).
        One NaN mask per chunk on the buffer's device; only the energies
        and the per-iteration counts reach the host. On a card this runs
        on a side stream, so it does not wait for chunks queued behind."""
        n = self.buf.shape[0] if self.n_valid < 0 else self.n_valid
        E = self.buf[:n, self.plane, :]

        def compact():
            mask = ~torch.isnan(E)
            counts = mask.sum(dim=1).cpu().numpy()
            return E[mask].cpu().numpy(), counts

        if E.device.type == "cuda":
            side = _side_streams.get(E.device)
            if side is None:
                side = _side_streams[E.device] = torch.cuda.Stream(E.device)
            if self.ready is not None:
                side.wait_event(self.ready)
            with torch.cuda.stream(side):
                vals, counts = compact()
        else:
            vals, counts = compact()
        vals, counts = _join_spans(vals, counts, self.mesh)
        return np.split(vals, np.cumsum(counts)[:-1])


def _join_spans(vals: np.ndarray, counts: np.ndarray, mesh):
    """Every process's compacted energies of a chunk (each process holds
    its span's, iteration-major), joined so that each iteration lists every
    process's in rank order: global slot order, as on one process. One
    all-gather of the counts and one of the values (the lists' lengths
    differ by process, so this is not :func:`~physicl_tpu_torch.parallel.
    distributed.fetch_to_every_host`, whose channel has one width). Off a
    mesh that spans processes, ``(vals, counts)`` as they are."""
    from physicl_tpu_torch.parallel.distributed import (
        all_gather_tensors,
        all_gather_varlen,
        mesh_spans_processes,
    )

    if not mesh_spans_processes(mesh):
        return vals, counts
    cs = [c.numpy() for (c,) in all_gather_tensors(
        [torch.from_numpy(np.asarray(counts, np.int64))])]
    vs = [v.numpy() for v in all_gather_varlen(torch.from_numpy(vals))]
    parts = [np.split(v, np.cumsum(c)[:-1]) for v, c in zip(vs, cs)]
    joined = [np.concatenate([p[i] for p in parts])
              for i in range(len(counts))]
    out = (np.concatenate(joined) if joined
           else np.zeros(0, vals.dtype))
    return out, np.sum(cs, axis=0)


def _prefix(sl, n: int) -> int:
    if not (isinstance(sl, slice) and sl.start is None and sl.step is None):
        raise TypeError("stream records support prefix slicing only")
    return n if sl.stop is None else min(int(sl.stop), n)


class FusedProvider:
    """Engine chunk contract backed by the fused transport."""

    def __init__(self, sim, plan: F.FusedPlan, rec_map: List[dict], dt_fn,
                 dt_before_kin: bool, measure_after_update: Dict[str, bool],
                 exit_fn, exit_mode: str, notes: List[str]):
        self.sim = sim
        self.plan = plan
        self.notes = list(notes)  # how the prover shaped the plan
        self.rec_map = rec_map
        self.dt_fn = dt_fn
        self.exit_fn = exit_fn
        self.exit_mode = exit_mode  # "t" | "n0"
        self.measure_after_update = measure_after_update
        self.update_first = dt_before_kin
        # host clock mirrors: the Kahan-compensated f32 clock, replayed
        # bit for bit as the JAX package replays it
        self.t_h = np.float32(0.0)
        self.dt_h = np.float32(0.0)
        self.comp_h = np.float32(0.0)
        self.n_h = 0
        self.hwm_h = 0  # host mirror of the device spawn mark
        self.capacity = 0
        self.chunk_idx = 0
        self.emit_ops = [op for op in plan.ops if op.kind == "emit"]
        self._synced = False
        self._last_state = None
        self._last_packed = None
        # per (device, first slot): the global slot ids of the planes a
        # launch covers, for retyping emitted slots
        self._slots: Dict[tuple, torch.Tensor] = {}
        self._full = False  # the last scheduled emission did not fit

    def invalidate(self) -> None:
        """The capacity changed (a shrink): drop the packed-state cache and
        re-read the clock, counts and capacity from the state at the next
        dispatch, which launches at the new capacity."""
        self._synced = False
        self._last_state = None
        self._last_packed = None
        self._slots = {}

    def resync(self, state: SimState, counts=None) -> None:
        """Re-read the alive count and spawn mark after an out-of-band state
        edit that kept the capacity (slot-recycling compaction, boundary
        population control); ``counts=(n_alive, n_spawned)`` skips the
        device read where the caller already made it."""
        self._last_state = None
        self._last_packed = None
        if counts is None:
            counts = torch.stack([state.n_alive.to(torch.int64),
                                  state.n_spawned.to(torch.int64)]).tolist()
        self.n_h, self.hwm_h = int(counts[0]), int(counts[1])

    def permute(self, state: SimState, perm: torch.Tensor):
        """``state`` with its slots reordered by ``perm`` (the spatial
        sort), or None where the packed-state cache does not hold it. One
        gather of the packed planes takes the place of a gather a plane
        and of the repack the next dispatch would make; the planes outside
        the pack (``a``, ``otype``, the extras the kernel does not write
        back) move by a gather each."""
        if (state is not self._last_state or self._last_packed is None
                or self.sim.mesh is not None):
            return None  # (a mesh sorts its gathered global planes)
        from physicl_tpu_torch.ops.compaction import take_slots

        plan = self.plan
        wb = set(plan.extras_writeback)
        packed = self._last_packed.index_select(1, perm)
        template = state.replace(
            a=take_slots(state.a, perm), otype=take_slots(state.otype, perm),
            extras={k: v if k in wb else take_slots(v, perm)
                    for k, v in state.extras.items()})
        moved = F.unpack_state(packed, template, plan.extras,
                               plan.extras_writeback)
        self._last_state, self._last_packed = moved, packed
        return moved

    def exit_pending(self) -> bool:
        """True when the next dispatch would run no iteration: a t-exit
        already satisfied by the host clock (no chunk-boundary population
        control after the final chunk)."""
        return (self.exit_mode == "t"
                and bool(self.exit_fn(_TOnly(self.t_h, self.dt_h))))

    def _host_schedule(self):
        """Replay K iterations of the time stepping on the host (plain
        numpy f32 Kahan arithmetic, as in the JAX package). Returns the
        per-iteration clocks, the dt at kinematics, the number of live
        iterations and whether a t-mode exit fires inside this chunk."""
        K = self.plan.chunk
        f32 = np.float32
        ts = np.zeros(K, f32)
        ts_before = np.zeros(K, f32)
        dts_kin = np.zeros(K, f32)
        dts_after = np.zeros(K, f32)
        dts_before = np.zeros(K, f32)
        comps = np.zeros(K, f32)
        comps_before = np.zeros(K, f32)
        emit_starts = np.full((max(1, len(self.emit_ops)), K),
                              _EMIT_INACTIVE, np.int32)
        hwm_after = np.full(K, self.hwm_h, np.int64)
        t, dt, comp = self.t_h, self.dt_h, self.comp_h
        hwm = self.hwm_h
        k_act, done_t = K, False

        def advance(t, dt, comp):
            y = f32(dt - comp)
            t_new = f32(t + y)
            comp = f32(f32(t_new - t) - y)
            return t_new, comp

        for i in range(K):
            if self.exit_mode == "t" and bool(self.exit_fn(_TOnly(t, dt))):
                k_act, done_t = i, True
                break
            ts_before[i] = t
            dts_before[i] = dt
            comps_before[i] = comp
            if self.update_first:
                dt = f32(_as_f(self.dt_fn(_TOnly(t, dt))))
                t, comp = advance(t, dt, comp)
                dts_kin[i] = dt
            else:
                dts_kin[i] = dt  # kinematics uses last iteration's dt
                dt = f32(_as_f(self.dt_fn(_TOnly(t, dt))))
                t, comp = advance(t, dt, comp)
            ts[i] = t
            dts_after[i] = dt
            comps[i] = comp
            for j, op in enumerate(self.emit_ops):
                # contiguous slots from the spawn mark; stop at capacity
                if hwm + op.emit_n <= self.capacity:
                    emit_starts[j, i] = hwm
                    hwm += op.emit_n
                    self._full = False
                elif not self._full:  # emission stops: the arena is full
                    self._full = True
                    self.sim.population_log.append(
                        ("capacity-stop", self.chunk_idx, i, hwm))
            hwm_after[i] = hwm
        return (ts, ts_before, dts_kin, dts_after, dts_before, k_act,
                done_t, emit_starts, hwm_after, comps, comps_before)

    def dispatch(self, state: SimState) -> _Inflight:
        """Enqueue one chunk and return a handle without waiting for it.
        The host clock mirrors advance optimistically from the schedule
        (exact except on the last chunk of an extinction run, which
        :meth:`harvest` trims)."""
        dev = state.device
        if not self._synced:
            self.n_h = int(state.n_alive)
            self.t_h = np.float32(float(state.t))
            self.dt_h = np.float32(float(state.dt))
            self.comp_h = np.float32(float(state.t_comp))
            self.hwm_h = int(state.n_spawned)
            self.capacity = state.capacity
            self._synced = True

        (ts, ts_before, dts_kin, dts_after, dts_before, k_act, done_t,
         emit_starts, hwm_after, comps, comps_before) = self._host_schedule()

        seed = int(((int(self.sim.seed) * 2_654_435_761
                     + self.chunk_idx * 40_503) & 0xFFFFFFFF) & 0x7FFFFFFF)
        self.chunk_idx += 1

        # sched rows: [dt at kinematics, t after update, t before update,
        #              dt after update, dt before update]
        sched = torch.from_numpy(np.stack(
            [dts_kin, ts, ts_before, dts_after, dts_before]))
        hwm_before = self.hwm_h
        if k_act:
            self.t_h = np.float32(ts[k_act - 1])
            self.dt_h = np.float32(dts_after[k_act - 1])
            self.comp_h = np.float32(comps[k_act - 1])
            self.hwm_h = int(hwm_after[k_act - 1])
            self.sim._hwm = self.hwm_h
        scalars = {"t": self.t_h, "dt": self.dt_h, "t_comp": self.comp_h}
        if self.sim.mesh is not None:
            new_state, out, rec, rec_f, stream = self._launch_shards(
                state, sched, emit_starts, seed, k_act, hwm_before,
                scalars)
        else:
            cached = (self._last_packed if state is self._last_state
                      else None)
            new_state, out, rec, rec_f, stream = self._launch(
                state, sched, emit_starts, seed, k_act, hwm_before,
                scalars, 0, cached)
        if not self.plan.n_frec_cols:
            rec_f = None
        ready = None
        if dev.type == "cuda":
            # start the record transfers now: they land as soon as the
            # kernel retires, and harvest() only waits on the event
            rec = _to_pinned(rec)
            rec_f = None if rec_f is None else _to_pinned(rec_f)
            # timed, so that a rate can be read on the device's clock
            ready = torch.cuda.Event(enable_timing=True)
            ready.record(torch.cuda.current_stream(dev))
        self._last_state = new_state
        self._last_packed = out
        return _Inflight(
            state=new_state, rec=rec, rec_f=rec_f, ready=ready,
            stream=stream, k_act=k_act,
            done_t=done_t, ts=ts, ts_before=ts_before, dts_after=dts_after,
            dts_before=dts_before, comps=comps, comps_before=comps_before,
            t_opt=np.float32(self.t_h), dt_opt=np.float32(self.dt_h),
            mesh=self.sim.mesh)

    def _launch(self, state: SimState, sched: torch.Tensor, emit_starts,
                seed: int, k_act: int, hwm_before: int, scalars: dict,
                offset: int = 0, packed=None):
        """Launch one chunk on ``state``'s planes: the kernel on a card, the
        twin on the CPU. ``offset`` is the planes' first global slot (a
        shard's; 0 on one device): the emit windows shift into local slots,
        and the slots emitted into (global ``[hwm_before, hwm_h)``) turn
        photons with zeroed extras. ``packed`` reuses a shard's packed
        planes. Returns ``(state, packed out, rec, rec_f, stream)``."""
        dev = state.device
        plan = self.plan
        if packed is None:
            packed = F.pack_state(state, plan.extras)
        starts = None
        if self.emit_ops:
            # windows straddling the shard's edges are written piecewise;
            # an inactive row stays far negative
            starts = torch.from_numpy(np.maximum(
                emit_starts.astype(np.int64) - offset,
                _EMIT_INACTIVE).astype(np.int32))
        if dev.type == "cuda":
            # from pinned memory: a pageable host-to-device copy would wait
            # for every chunk already queued and serialize the pipeline
            sched = sched.pin_memory().to(dev, non_blocking=True)
            if starts is not None:
                starts = starts.pin_memory().to(dev, non_blocking=True)
        out = None if dev.type == "cpu" else torch.empty_like(packed)
        out, rec, rec_f, *stream = F.fused_chunk(
            packed, sched, seed, k_act, plan, out=out, emit_starts=starts)
        new_state = F.unpack_state(out, state, plan.extras,
                                   plan.extras_writeback).replace(
            **{k: _scalar(v, state.t) for k, v in scalars.items()},
            n_spawned=_scalar(self.hwm_h, state.n_spawned))
        if self.hwm_h > hwm_before:
            # emitted slots are photons in the host-side otype mirror, and
            # start with zeroed extras planes (the kernel wrote the rest);
            # written-back planes already hold what the kernel wrote there
            # (a polarized source's Stokes and frame rows)
            slots = self._slots.get((dev, offset))
            if slots is None or slots.numel() != state.capacity:
                slots = self._slots[dev, offset] = torch.arange(
                    offset, offset + state.capacity, device=dev)
            emitted = (slots >= hwm_before) & (slots < self.hwm_h)
            wb = set(plan.extras_writeback)
            new_state = new_state.replace(
                otype=torch.where(emitted, OBJ_PHOTON, new_state.otype),
                extras={k: v if k in wb else torch.where(emitted, 0, v)
                        for k, v in new_state.extras.items()})
        return new_state, out, rec, rec_f, (stream[0] if stream else None)

    def _launch_shards(self, state, sched, emit_starts, seed: int,
                       k_act: int, hwm_before: int, scalars: dict):
        """One chunk over the mesh: :meth:`_launch` on each of this
        process's shards' local planes with the shard's seed
        (``shard_seed`` of its global index) and emit windows shifted by
        ``idx * local capacity`` (the JAX package's
        ``build_sharded_fused``). The record rows stay per shard,
        ``(shards, K, cols)`` over the columns in use, stacked on the first
        shard's device: :meth:`harvest` adds them in shard order on the
        host copies (across processes too, so that no collective waits on a
        chunk at dispatch). The stream planes join this process's span
        there, in global slot order. No fallback: a shard whose kernel
        fails raises."""
        from physicl_tpu_torch.parallel.sharding import (
            ShardedState,
            shard_seed,
        )

        sh = self.sim._shard(state)
        L = sh.local_capacity
        cached = (self._last_packed if state is self._last_state
                  and isinstance(self._last_packed, list) else None)
        shards, outs, recs, recfs, streams = [], [], [], [], []
        for j, st in enumerate(sh.shards):
            idx = sh.first + j
            on = (torch.cuda.device(st.device) if st.device.type == "cuda"
                  else contextlib.nullcontext())
            with on:
                res = self._launch(st, sched, emit_starts,
                                   shard_seed(seed, idx), k_act, hwm_before,
                                   scalars, idx * L,
                                   None if cached is None else cached[j])
            for acc, x in zip((shards, outs, recs, recfs, streams), res):
                acc.append(x)
        dev = sh.device
        stream = (torch.cat([x.to(dev) for x in streams], dim=-1)
                  if self.plan.n_stream else None)
        nc = max(1, self.plan.n_rec_cols)
        nf = max(1, self.plan.n_frec_cols)
        return (ShardedState(shards, sh.mesh), outs,
                torch.stack([r[:, :nc].to(dev) for r in recs]),
                torch.stack([r[:, :nf].to(dev) for r in recfs]), stream)

    def harvest(self, inflight: _Inflight):
        """Wait for a dispatched chunk's records and classify its exit.
        Returns ``(done, final_state, records, n_valid, stats)``. Chunks
        must be harvested in dispatch order (the alive-count chain threads
        through consecutive harvests)."""
        K = self.plan.chunk
        k_act = inflight.k_act
        if inflight.ready is not None:
            inflight.ready.synchronize()
        if inflight.mesh is not None:
            _combine_shards(inflight)
        rec_np = inflight.rec.numpy()
        recf_np = None if inflight.rec_f is None else inflight.rec_f.numpy()

        n_end = rec_np[:, 0]
        n_before = np.concatenate([[self.n_h], n_end[:-1]])
        if self.exit_mode == "n0":
            alive_iters = n_before > 0
            n_valid = int((alive_iters & (np.arange(K) < k_act)).sum())
            done = bool((~alive_iters[:k_act]).any())
        else:
            n_valid = k_act
            done = inflight.done_t
        if n_valid:
            self.n_h = int(n_end[n_valid - 1])

        final_state = inflight.state
        if done and self.exit_mode == "n0" and n_valid < k_act:
            # extinction fired mid-chunk: trim the optimistic clocks
            if n_valid:
                fix = (inflight.ts[n_valid - 1],
                       inflight.dts_after[n_valid - 1],
                       inflight.comps[n_valid - 1])
            else:
                fix = (inflight.ts_before[0], inflight.dts_before[0],
                       inflight.comps_before[0])
            self.t_h, self.dt_h, self.comp_h = (np.float32(x) for x in fix)
            st = inflight.state
            final_state = st.replace(
                t=_scalar(self.t_h, st.t), dt=_scalar(self.dt_h, st.t),
                t_comp=_scalar(self.comp_h, st.t))
            self._last_state = final_state
        stats = {"t": float(self.t_h if done else inflight.t_opt),
                 "dt": float(self.dt_h if done else inflight.dt_opt),
                 "n_alive": int(self.n_h)}

        ts, ts_before = inflight.ts, inflight.ts_before
        records = {}
        # one holder per chunk: every trace step references the same buffer
        hold = _StreamHold(inflight.stream)
        for m in self.rec_map:
            uid = m["uid"]
            t_arr = (ts if self.measure_after_update.get(uid, True)
                     else ts_before)
            if m["kind"] == "ts":
                records[f"{uid}/ts"] = ts
            elif m["kind"] == "dep":
                records[f"{uid}/t"] = t_arr
                records[f"{uid}/dep"] = recf_np[:, m["col"]]
            elif m["kind"] == "sign":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                src = recf_np if m["weighted"] else rec_np
                records[f"{uid}/signs"] = src[:, m["sx_col"]:m["sx_col"] + 3]
            elif m["kind"] == "cross":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                src = recf_np if m["weighted"] else rec_np
                for j, col in enumerate(m["cnt_cols"]):
                    records[f"{uid}/count{j}"] = src[:, col]
                for j, col in enumerate(m["e_cols"]):
                    if col >= 0:
                        records[f"{uid}/Esum{j}"] = recf_np[:, col]
                for j, p in enumerate(m.get("ecap_planes", ())):
                    if p >= 0:  # per-photon E capture, compacted in collect
                        records[f"{uid}/E{j}"] = _EList(
                            inflight.stream, p, inflight.ready,
                            mesh=inflight.mesh)
            elif m["kind"] == "reduce":
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                for j, name in enumerate(m["names"]):
                    records[f"{uid}/{name}"] = recf_np[:, m["f0"] + j]
            elif m["kind"] == "polmeas":
                # the kernel sums weight, p, V (, Q, U): the means divide
                # by the weight sum, as the JAX package's harvest does
                records[f"{uid}/t"] = t_arr
                if m["n_col"] >= 0:
                    records[f"{uid}/n"] = rec_np[:, m["n_col"]]
                f0 = m["f0"]
                denom = np.maximum(recf_np[:, f0], 1e-30)
                names = ("p_mean", "V_mean") + (("Q_mean", "U_mean")
                                                if m["local_qu"] else ())
                for j, name in enumerate(names):
                    records[f"{uid}/{name}"] = recf_np[:, f0 + 1 + j] / denom
            elif m["kind"] == "trace":
                # the raw buffer: the step slices at assembly time
                records[f"{uid}/traceraw"] = _TraceRaw(
                    hold=hold, p0=m["p0"], scat=m["scat"],
                    every=self.plan.stream_every)
        return done, final_state, records, n_valid, stats

    def __call__(self, state: SimState):
        """One chunk, dispatched and harvested at once, for direct callers;
        the engine pipelines :meth:`dispatch` / :meth:`harvest` instead.
        Returns ``(final_state, done, records, valid)``."""
        done, final_state, records, n_valid, _ = self.harvest(
            self.dispatch(state))
        return final_state, done, records, np.arange(self.plan.chunk) < n_valid


def _combine_shards(inflight: _Inflight) -> None:
    """A chunk's record rows on a mesh: every shard's rows (this process
    holds its own shards', on the host) added in global shard order
    (:func:`physicl_tpu_torch.parallel.sharding.reduce_sum`, which
    all-gathers them first across processes), into the ``(K, 128)`` layout
    of one device's rows: integer rows exactly, float rows in that fixed
    order. Every process then reads the same rows, bit for bit those of
    the one-process mesh."""
    from physicl_tpu_torch.parallel.sharding import reduce_sum

    cpu = torch.device("cpu")
    for name in ("rec", "rec_f"):
        rows = getattr(inflight, name)
        if rows is None:
            continue
        total = reduce_sum(list(rows.unbind(0)), cpu, inflight.mesh)
        full = torch.zeros((total.shape[0], F._MAX_REC_COLS),
                           dtype=total.dtype)
        full[:, :total.shape[1]] = total
        setattr(inflight, name, full)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """Start a device-to-host copy of ``t`` into pinned memory."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """0-d tensor of ``like``'s dtype and device holding ``x``. ``full``
    writes it with a fill kernel: no host-to-device copy, no stream sync."""
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _whole_periods(chunk: int, every: int, periods, budget: int,
                   row_bytes: int):
    """``(chunk, stride)`` for a stream of stride ``every``: the chunk cut to
    whole multiples of every trace period, so that the sampled iterations
    stay global multiples across chunk boundaries; below one period, every
    iteration is sampled instead (stride 1) and the stream budget applies
    at one row per iteration."""
    period_lcm = math.lcm(*periods)
    if chunk >= period_lcm:
        return (chunk // period_lcm) * period_lcm, every
    return max(1, min(chunk, budget // row_bytes)), 1


def _population_sources(sim, state: SimState) -> tuple:
    """``(objects, bulks)`` that the prover reads the population's
    species, speeds and planes from: the pending population the state was
    built from, or, for a run restored from a checkpoint (whose state
    ignores the pending population), one bulk view per species of the
    state's live slots. The JAX prover reads the pending population in
    both cases, and refuses a restored run without one as
    ``empty-population`` (its generic scan runs it)."""
    if not sim._restored_run:
        return sim._pending_objects, sim._pending_bulk
    bulks = []
    for code in torch.unique(state.otype[state.alive]).tolist():
        idx = torch.nonzero(state.alive & (state.otype == code)).flatten()
        bulks.append({"n": int(idx.numel()), "otype": int(code),
                      "v": state.v[:, idx],
                      "extras": {k: x[..., idx]
                                 for k, x in state.extras.items()}})
    return [], bulks


def _population_pol_planes(objects, bulks) -> tuple:
    """The subset of ``("stokes", "pol_ref")`` that any source declares (a
    bulk's ``"extras"`` or an object's attribute). A fluorescent del
    zeroes each one it finds, so a population that declares only one
    still packs and writes that one back."""
    found = set()
    for b in bulks:
        found.update(nm for nm in ("stokes", "pol_ref")
                     if nm in (b.get("extras") or {}))
    for o in objects:
        found.update(nm for nm in ("stokes", "pol_ref") if hasattr(o, nm))
    return tuple(nm for nm in ("stokes", "pol_ref") if nm in found)


_EXTRAS_CORE = {"r", "dr", "v", "dv", "a", "E", "w"}


def _population_extras_rows(objects, bulks, name: str):
    """Rows the state assembly gives an extras plane (1 for a scalar, 3
    for a 3-vector), or None if no source declares it."""
    if name.startswith("_") or name in _EXTRAS_CORE:
        return None
    for b in bulks:
        arr = (b.get("extras") or {}).get(name)
        if arr is not None:
            return 1 if arr.ndim == 1 else 3
    for o in objects:
        if hasattr(o, name):
            arr = np.asarray(raw_code_value(getattr(o, name)),
                             dtype=np.float64)
            if arr.shape == ():
                return 1
            if arr.shape == (3,):
                return 3
    return None


def try_build_fused(sim, steps, state: SimState,
                    report: Optional[list] = None) -> Optional[FusedProvider]:
    """Return a FusedProvider for the sim, or None with the refusal's
    ``(code, detail)`` appended to ``report``; without a ``report`` the
    refusal is raised as :class:`FusedRefusal`."""
    try:
        return _build_fused(sim, steps, state)
    except FusedRefusal as e:
        if report is None:
            raise
        report.append((e.code, e.detail))
        return None


def _build_fused(sim, steps, state: SimState) -> FusedProvider:
    from physicl_tpu_torch.engine import (
        ElementwiseStep,
        ReduceMeasureStep,
        UpdateTimeStep,
    )
    from physicl_tpu_torch.kernels import KernelStep
    from physicl_tpu_torch.ops import record as RC
    from physicl_tpu_torch.light import (
        PhotonEmitterStep,
        PlanckSampler,
        RefractiveInterfaceStep,
        ScatterComptonStep,
        ScatterDeleteStep,
        ScatterHenyeyGreensteinStep,
        ScatterIsotropicStep,
        ScatterMeasureStep,
        ScatterPhaseFunctionStep,
        ScatterRayleighStep,
        ScatterSignMeasureStep,
        SphericalShellMeasureStep,
        TracePathMeasureStep,
    )
    from physicl_tpu_torch.newton import (
        AbsorbingBoundaryStep,
        AbsorbingSphereStep,
        LorentzForceStep,
        NewtonianKinematicsStep,
        PeriodicBoundaryStep,
        ReflectingBoundaryStep,
        _static_bounds,
    )
    from physicl_tpu_torch.polarization import (
        ScatterPolarizedComptonStep,
        ScatterPolarizedRayleighStep,
        StokesMeasureStep,
    )

    def _no(code: str, detail: str):
        raise FusedRefusal(code, detail)

    # one recorded field per callable and variables (the callable is kept
    # in the entry: its id keys it)
    recorded_fields = {}

    def _field(step, fn, label, varnames, ncomp=1):
        """The kernel-evaluable field callable ``fn``, or a refusal. A
        torch callable is recorded into one field program of ``ncomp``
        outputs."""
        if fn is None:
            return None
        what = f"{type(step).__name__}'s {label}"
        spec = getattr(fn, "spec", None)
        if spec is None and callable(fn):
            key = (id(fn), varnames, ncomp)
            if key not in recorded_fields:
                try:
                    recorded_fields[key] = (fn, RC.record_field(
                        fn, varnames, what, ncomp=ncomp))
                except RC.Refused as e:
                    _no(e.code, f"{e.detail}; " + {
                        ("E",): "pass a C-expression string over E[gid]",
                        ("u",): "pass phase_table=(mu_grid, pdf)",
                    }.get(varnames, "pass a C-expression string, "
                          "light.layered_density or light.voxel_density"
                          if ncomp == 1 else "pass a constant 3-vector"))
            fn = recorded_fields[key][1]
            spec = fn.spec
        # layered and voxel fields are functions of position only
        if spec is None or spec.get("vars", _R) != varnames \
                or spec.get("n_out", 1) != ncomp:
            _no("field-fn-callable", f"{what} is not a field the kernel "
                f"evaluates over {varnames}; pass a C-expression string"
                + (" over E[gid]" if varnames == ("E",) else ", "
                   "light.layered_density or light.voxel_density"))
        if spec["kind"] == "expr" and spec["error"] is not None:
            if spec.get("raises") is not None:
                # the reference's eval raises on the string: an error, as
                # when the JAX kernel traces it
                raise spec["raises"](spec["error"])
            _no("field-expr-unsupported", spec["error"])
        if spec["kind"] == "voxel" and spec["flat"].size > FL.MAX_VOXELS:
            # the JAX prover's code where its kernel cannot hold a grid
            # (physicl_tpu/ops/pipeline.py:1156-1172): the generic tier
            # runs the plan
            _no("field-fn-gather", f"{what} has {spec['flat'].size} "
                f"voxels; the kernel's flat index is int32 (at most "
                f"{FL.MAX_VOXELS}); the generic step tier runs the plan")
        return fn

    if state.r.dtype != torch.float32:
        _no("dtype", f"state dtype {state.r.dtype}: the transport kernel is "
            "float32")
    # the population's species, known on the host: photons or generic
    # (charged) particles run with no per-particle type test; a mixed
    # population packs its otype codes as an extras plane that gates the
    # photon ops per particle
    objects, bulks = _population_sources(sim, state)
    codes = {int(getattr(o, "_obj_type_code", 0)) for o in objects}
    codes |= {int(b["otype"]) for b in bulks}
    if not codes:
        _no("empty-population", "no initial objects: add particles before "
            "start()")
    species = codes.pop() if len(codes) == 1 else F.SPECIES_MIXED
    if species not in (OBJ_PHOTON, F.SPECIES_MIXED) and any(
            type(s) is PhotonEmitterStep for s in steps):
        # an emitter turns a non-photon population mixed at its first
        # emission: plan the otype-gated kernel from the start
        species = F.SPECIES_MIXED
    # the Stokes and frame planes the population declares, and whether it
    # declares both (what the polarized ops need; from_population zero-fills
    # the rest: unpolarized, a degenerate frame)
    declared = _population_pol_planes(objects, bulks)
    has_stokes = declared == ("stokes", "pol_ref")
    pol_steps = (ScatterPolarizedRayleighStep, ScatterPolarizedComptonStep)
    # the polarization planes to pack: both for a polarized scatter or
    # source, Stokes for the tally, and for a fluorescent del (which zeroes
    # them in re-emitted photons) each plane the population declares
    pol_bases = set()
    for s in steps:
        if type(s) in pol_steps or (type(s) is PhotonEmitterStep
                                    and s.stokes is not None):
            pol_bases |= set(declared) if has_stokes else set()
        elif type(s) is StokesMeasureStep and has_stokes:
            pol_bases.add("stokes")
        elif type(s) is ScatterDeleteStep and s.fluorescence:
            pol_bases |= set(declared)
    # planes packed after the core 15 (F.pack_state's names): the Stokes
    # rows, then the frame rows, at the fixed places the kernel reads them
    # from (F.POL_ROWS), then the otype codes of a mixed population
    extra_names: List[str] = [f"{b}:{i}" for b in ("stokes", "pol_ref")
                              if b in pol_bases for i in range(3)]
    if species == F.SPECIES_MIXED:
        extra_names.append("otype")
    pol_wb = set()  # the polarization planes an op mutates: written back
    user_wb: List[str] = []  # ElementwiseStep extras_write bases, in order

    def view_extras(step):
        """``(name, first packed plane, rows)`` of a user step's declared
        extras, packing the planes it needs; a missing one refuses."""
        entries = []
        for name in step.extras:
            rows = _population_extras_rows(objects, bulks, name)
            if rows is None:
                _no("extras-missing", f"{type(step).__name__} declares "
                    f"extras={step.extras} but no pending population carries "
                    f"a '{name}' plane (Object kwargs, a bulk's 'extras')")
            packed = ([name] if rows == 1
                      else [f"{name}:{i}" for i in range(rows)])
            for nm in packed:
                if nm not in extra_names:
                    extra_names.append(nm)
            entries.append((name, F._NF + extra_names.index(packed[0]),
                            rows))
        return tuple(entries)

    def recorded(prefix, record, *args, **kw):
        """A user callable's program, or its refusal, its code with the
        step's prefix."""
        try:
            return record(*args, **kw)
        except RC.Refused as e:
            _no(f"{prefix}-{e.code}", e.detail)

    ops: List[F._Op] = []
    rec_map: List[dict] = []
    measure_after_update: Dict[str, bool] = {}
    next_col = 1
    next_fcol = 0   # float record channels (weight and energy sums)
    next_plane = 0  # stream planes (trace positions, captured energies)
    dt_fn = None
    update_seen = False
    update_before_kin = False
    kin_seen = False

    def dep_col(s):
        """A per-iteration deposition (Compton: heating) float column for a
        step with ``measure_deposition``, else ``()``."""
        nonlocal next_fcol
        if not s.measure_deposition:
            return ()
        next_fcol += 1
        rec_map.append({"uid": s._step_uid, "kind": "dep",
                        "col": next_fcol - 1})
        measure_after_update[s._step_uid] = update_seen
        return (next_fcol - 1,)

    # photon physics: gated per particle on a mixed population, an exact
    # no-op on a purely non-photon one (refused, as the JAX prover does, so
    # that a likely mistake does not pass silently). The JAX prover leaves
    # ScatterPhaseFunctionStep out and fuses it ungated, scattering
    # non-photons that its generic tier leaves alone; the port refuses it.
    photon_only = (ScatterDeleteStep, ScatterIsotropicStep,
                   ScatterHenyeyGreensteinStep, ScatterRayleighStep,
                   ScatterPhaseFunctionStep, ScatterComptonStep,
                   RefractiveInterfaceStep, PhotonEmitterStep, *pol_steps)

    def need_stokes(step, what):
        """The polarization-planes refusal: the population must declare
        both planes (the generic tier raises the instructive error)."""
        if not has_stokes:
            _no("polarization-planes", f"{what} but no pending population "
                "declares 'stokes' + 'pol_ref' extras (polarization."
                "polarized_photon_state)")
    for s in steps:
        uid = s._step_uid
        # a plan never holds a tensor: a parameter that carries a graph (a
        # grad input, a vmap batch) sends the plan to the generic tier,
        # which keeps it in the graph (every other tensor parameter was
        # folded to a host float by the constructor)
        traced = sorted(k for k, v in vars(s).items() if is_traced(v))
        if traced:
            _no("unsupported-step", f"{type(s).__name__} holds tensor "
                f"parameters that carry a graph ({', '.join(traced)}): the "
                "fused kernel takes host constants; the generic step tier "
                "keeps the graph")
        if getattr(s, "at_boundary", False) and hasattr(s, "boundary_apply"):
            # chunk-boundary population control (light._SplitBase with
            # at="chunk"): applied between dispatches by the
            # PopulationManager, not in the kernel
            continue
        if isinstance(s, photon_only) and species not in (OBJ_PHOTON,
                                                          F.SPECIES_MIXED):
            _no("photon-only-op", f"{type(s).__name__} acts on photons but "
                "the population is non-photon (and no emitter adds any)")
        if type(s) is UpdateTimeStep:
            if update_seen:
                _no("duplicate-update-step", "more than one UpdateTimeStep; "
                    "the fused time schedule is replayed from a single dt "
                    "function")
            if not _probe_t_only(s.fn):
                _no("dt-fn-not-t-only", "the UpdateTimeStep function reads "
                    "sim attributes beyond (t, dt); the host time-schedule "
                    "replay can only feed it the clock")
            update_seen = True
            update_before_kin = not kin_seen
            dt_fn = s.fn
            rec_map.append({"uid": uid, "kind": "ts"})
        elif type(s) is NewtonianKinematicsStep:
            if s.integrate_acceleration:
                _no("kinematics-acceleration", "NewtonianKinematicsStep("
                    "integrate_acceleration=True): a/dv planes are not in "
                    "the packed kernel state")
            kin_seen = True
            ops.append(F._Op("kin"))
        elif type(s) is LorentzForceStep:
            if s.q_over_m is None and not (
                    any(hasattr(o, "q") for o in objects)
                    and any(hasattr(o, "m") for o in objects)):
                _no("lorentz-per-particle", "LorentzForceStep(q_over_m=None)"
                    " needs per-particle q/m extras and no initial object "
                    "declares q= and m= (newton.ChargedObject)")
            if species == OBJ_PHOTON:
                # photons are never pushed, but the step still zeroes dv:
                # q/m = 0 and no fields leave v as it is and dv = 0
                ops.append(F._Op("lorentz", after_update=update_seen))
                continue
            # a callable field: recorded, one program of three outputs,
            # and evaluated at the particle's position
            e_fn = (_field(s, s._e_fn, "E_field", _R, ncomp=3)
                    if s._e_const is None else None)
            b_fn = (_field(s, s._b_fn, "B_field", _R, ncomp=3)
                    if s._b_const is None else None)
            qm_plane = -1
            if s.q_over_m is None:  # per-particle q/m: a derived plane
                if "qm" not in extra_names:
                    extra_names.append("qm")
                qm_plane = F._NF + extra_names.index("qm")
            ops.append(F._Op("lorentz", qm=s.q_over_m or 0.0,
                             qm_plane=qm_plane, e_const=s._e_const or (),
                             b_const=s._b_const or (), e_fn=e_fn,
                             b_fn=b_fn, after_update=update_seen))
        elif type(s) is ScatterDeleteStep:
            n_fn = _field(s, s._n_fn, "variable_n_fn", _R)
            a_fn = _field(s, s._a_fn, "A_fn", ("E",))
            dep_cols = dep_col(s)
            if s.fluorescence:  # zeroes the re-emitted photons' planes
                pol_wb |= set(declared)
            ops.append(F._Op("del", coef=s._coef, n_fn=n_fn, a_fn=a_fn,
                             implicit_capture=s.implicit_capture,
                             roulette=tuple(s.roulette or ()),
                             stretch=tuple(s.stretch or ()),
                             fluor=tuple(s.fluorescence or ()),
                             c_val=s._c, cols=dep_cols))
        elif type(s) is ScatterIsotropicStep:
            s.setup(sim)
            n_fn = _field(s, s._n_fn, "variable_n_fn", _R)
            ops.append(F._Op("iso", coef=s._coef, wl_base=s._wl_base,
                             c_val=s._c, n_fn=n_fn))
        elif type(s) in (ScatterHenyeyGreensteinStep, ScatterRayleighStep,
                         ScatterPhaseFunctionStep):
            kind = {ScatterHenyeyGreensteinStep: "hg",
                    ScatterRayleighStep: "rayl",
                    ScatterPhaseFunctionStep: "phase"}[type(s)]
            # a callable inverse CDF u -> cos theta: recorded, and
            # evaluated at the draw where the table route reads its knots
            phase_fn = (_field(s, s._icdf, "cos_theta_icdf", ("u",))
                        if kind == "phase" and s._knots is None else None)
            s.setup(sim)
            n_fn = _field(s, s._n_fn, "variable_n_fn", _R)
            ops.append(F._Op(kind, coef=s._coef, wl_base=s._wl_base,
                             c_val=s._c, n_fn=n_fn,
                             g=s.g if kind == "hg" else 0.0,
                             phase_knots=s._knots if kind == "phase"
                             else None, phase_fn=phase_fn))
        elif type(s) is ScatterComptonStep:
            s.setup(sim)
            n_fn = _field(s, s._n_fn, "variable_n_fn", _R)
            ops.append(F._Op("compton", coef=s._coef, n_fn=n_fn, c_val=s._c,
                             inv_mec2=s._inv_mec2,
                             kn_xsec=s.kn_cross_section,
                             kn_tries=s.kn_max_tries,
                             theta_e=float(s._theta_e or 0.0),
                             cols=dep_col(s)))
        elif type(s) in pol_steps:
            need_stokes(s, type(s).__name__)
            s.setup(sim)
            n_fn = _field(s, s._n_fn, "variable_n_fn", _R)
            pol_wb |= {"stokes", "pol_ref"}
            if type(s) is ScatterPolarizedRayleighStep:
                ops.append(F._Op("pol", coef=s._coef, wl_base=s._wl_base,
                                 c_val=s._c, n_fn=n_fn))
            else:
                ops.append(F._Op("polc", coef=s._coef, n_fn=n_fn,
                                 c_val=s._c, inv_mec2=s._inv_mec2,
                                 kn_xsec=s.kn_cross_section,
                                 kn_tries=s.kn_max_tries, cols=dep_col(s)))
        elif type(s) is StokesMeasureStep:
            need_stokes(s, "StokesMeasureStep")
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            f0 = next_fcol
            next_fcol += 5 if s.local_qu else 3
            ops.append(F._Op("polmeas", cols=(n_col, f0),
                             weighted=s.weighted, local_qu=s.local_qu))
            rec_map.append({"uid": uid, "kind": "polmeas", "n_col": n_col,
                            "f0": f0, "local_qu": s.local_qu})
            measure_after_update[uid] = update_seen
        elif type(s) is RefractiveInterfaceStep:
            s.setup(sim)
            ops.append(F._Op("fresnel", c_val=float(s._c), iface=(
                s.axis, float(s.loc), s.n_lo, s.n_hi, s.match_speed)))
        elif type(s) is AbsorbingBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("absorb", bounds=_static_bounds(s, sim)))
        elif type(s) is AbsorbingSphereStep:
            ops.append(F._Op("sabsorb", sphere=(*s.center, s.radius),
                             inside=s.kill_inside))
        elif type(s) is ReflectingBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("reflect", bounds=_static_bounds(s, sim)))
        elif type(s) is PeriodicBoundaryStep:
            s.setup(sim)
            ops.append(F._Op("periodic", bounds=_static_bounds(s, sim)))
        elif type(s) is SphericalShellMeasureStep:
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            if s.weighted:
                col = next_fcol
                next_fcol += 1
            else:
                col = next_col
                next_col += 1
            ops.append(F._Op("scross", sphere=(*s.center, s.radius),
                             cols=(n_col, col), weighted=s.weighted))
            rec_map.append({"uid": uid, "kind": "cross", "n_col": n_col,
                            "cnt_cols": [col], "e_cols": [],
                            "weighted": s.weighted})
            measure_after_update[uid] = update_seen
        elif type(s) is TracePathMeasureStep:
            p0 = next_plane
            next_plane += 3 + (1 if s.trace_dv else 0)
            ops.append(F._Op("trace", stream0=p0, stream_scat=s.trace_dv,
                             stream_every=s.trace_every))
            rec_map.append({"uid": uid, "kind": "trace", "p0": p0,
                            "scat": s.trace_dv, "every": s.trace_every})
        elif type(s) is ScatterSignMeasureStep:
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            if s.weighted:  # weight sums live in float record channels
                sx = next_fcol
                next_fcol += 3
            else:
                sx = next_col
                next_col += 3
            ops.append(F._Op("sign", cols=(n_col, sx), weighted=s.weighted))
            rec_map.append({"uid": uid, "kind": "sign", "n_col": n_col,
                            "sx_col": sx, "weighted": s.weighted})
            measure_after_update[uid] = update_seen
        elif type(s) is PhotonEmitterStep:
            if callable(s.E) and not isinstance(s.E, PlanckSampler):
                _no("emitter-sampler", f"PhotonEmitterStep energy sampler "
                    f"{type(s.E).__name__}: a user callable cannot be "
                    "inlined into the CUDA kernel; PlanckSampler energies "
                    "are sampled in-kernel")
            s.setup(sim)
            if s.isotropic:
                emit_v = None
            elif s.v is None:
                emit_v = (s._c, 0.0, 0.0)
            else:
                emit_v = tuple(float(x) for x in np.asarray(
                    raw_code_value(s.v), np.float64).reshape(3))
            sampled = isinstance(s.E, PlanckSampler)
            emit_stokes, emit_polref = (), ()
            if s.stokes is not None:
                need_stokes(s, "polarized PhotonEmitterStep (stokes=)")
                pol_wb |= {"stokes", "pol_ref"}
                emit_stokes = tuple(float(x) for x in s.stokes)
                emit_polref = tuple(float(x) for x in s._emit_e1)
            ops.append(F._Op(
                "emit", emit_n=s.n_per_step, c_val=s._c,
                emit_E=0.0 if sampled else float(raw_code_value(s.E)),
                emit_table=(icdf_table(s.E.data) if sampled else None),
                emit_scale=s.E._code if sampled else 1.0,
                emit_r=tuple(float(x) for x in s.r), emit_v=emit_v,
                emit_row=sum(1 for o in ops if o.kind == "emit"),
                emit_stokes=emit_stokes, emit_polref=emit_polref))
        elif type(s) is ElementwiseStep:
            # user physics recorded into kernel 1i's program: t and dt of
            # its place; declared extras pack as planes, extras_write ones
            # are written back
            ve = view_extras(s)
            prog = recorded("elementwise", RC.record_particle_fn, s.fn,
                            "ElementwiseStep", ve, s.extras_write)
            user_wb.extend(s.extras_write)
            ops.append(F._Op("custom", prog=prog, after_update=update_seen))
        elif isinstance(s, ReduceMeasureStep) and (
                type(s).apply is ReduceMeasureStep.apply
                and type(s)._contributions
                is ReduceMeasureStep._contributions):
            # per-particle contributions summed over alive particles into
            # one float column each (subclasses that only configure the
            # constructor, as light.SpectrumMeasureStep and MeshTallyStep,
            # are their fn; one that overrides apply or _contributions is
            # an unsupported step, as in the JAX prover)
            ve = view_extras(s)
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            f0 = next_fcol
            next_fcol += len(s.outputs)
            binning = getattr(s, "binning", None)
            if binning is not None and s.fn == binning.contributions:
                # a histogram tally (SpectrumMeasureStep, MeshTallyStep):
                # its coordinate and value recorded, one bin a slot
                prog = recorded("reduce", RC.record_binned, binning,
                                type(s).__name__)
                bins = F.Bins(tuple(float(np.float32(e))
                                    for e in binning.edges),
                              binning.underflow, binning.overflow,
                              binning.value is None)
            else:
                prog = recorded("reduce", RC.record_particle_fn, s.fn,
                                "ReduceMeasureStep", ve, outputs=s.outputs,
                                f0=f0)
                bins = None
            ops.append(F._Op("reduce", prog=prog, cols=(n_col, f0),
                             after_update=update_seen, bins=bins))
            rec_map.append({"uid": uid, "kind": "reduce", "n_col": n_col,
                            "f0": f0, "names": s.outputs})
            measure_after_update[uid] = update_seen
        elif type(s) is KernelStep and s.elementwise:
            # a SimState -> SimState map over the kernel's facade; records
            # reduce across particles (ReduceMeasureStep's job)
            if s.record_fn is not None:
                _no("kernelstep-records", "KernelStep(elementwise=True) with "
                    "record_fn=: records reduce across particles; use "
                    "ReduceMeasureStep for fused measurement")
            otype_plane = (F._NF + extra_names.index("otype")
                           if species == F.SPECIES_MIXED else -1)
            prog = recorded("kernelstep", RC.record_kernelstep, s.fn,
                            otype_plane, species)
            ops.append(F._Op("kstate", prog=prog, after_update=update_seen))
        elif type(s) is ScatterMeasureStep:
            n_col = next_col if s.measure_n else -1
            next_col += 1 if s.measure_n else 0
            axes, cnt_cols, e_cols, ecap_planes = [], [], [], []
            for axis, L in s._axes:
                e_col = ecap = -1
                if s.measure_E and s.measure_E_mode == "sum":
                    e_col = next_fcol
                    next_fcol += 1
                elif s.measure_E:  # per-photon E capture: one stream plane
                    ecap = next_plane
                    next_plane += 1
                if s.weighted:  # weight sums live in float record channels
                    cnt = next_fcol
                    next_fcol += 1
                else:
                    cnt = next_col
                    next_col += 1
                axes.append((axis, L, cnt, e_col, ecap))
                cnt_cols.append(cnt)
                e_cols.append(e_col)
                ecap_planes.append(ecap)
            ops.append(F._Op("cross", cols=(n_col,), axes=tuple(axes),
                             weighted=s.weighted))
            rec_map.append({"uid": uid, "kind": "cross", "n_col": n_col,
                            "cnt_cols": cnt_cols, "e_cols": e_cols,
                            "ecap_planes": ecap_planes,
                            "weighted": s.weighted})
            measure_after_update[uid] = update_seen
        else:
            _no("unsupported-step", f"{type(s).__name__} has no fused op in "
                "the port; supported: UpdateTime/NewtonianKinematics/"
                "LorentzForce/Absorbing/Reflecting/PeriodicBoundary/"
                "AbsorbingSphere/ScatterDelete/ScatterIsotropic/"
                "ScatterHenyeyGreenstein/ScatterRayleigh/ScatterPhaseFunction/"
                "ScatterCompton/ScatterPolarizedRayleigh/"
                "ScatterPolarizedCompton/StokesMeasure/"
                "RefractiveInterface/PhotonEmitter/ScatterSignMeasure/"
                "ScatterMeasure/SphericalShellMeasure/TracePathMeasure/"
                "Elementwise/ReduceMeasure (Spectrum, MeshTally)/"
                "KernelStep(elementwise=True)")

    if not update_seen:
        _no("no-update-step", "no UpdateTimeStep: the fused kernel "
            "precomputes the time schedule on the host and needs a dt "
            "function")
    if next_col > F._MAX_REC_COLS or next_fcol > F._MAX_REC_COLS:
        _no("record-columns", f"measurement channels exceed the record "
            f"width ({max(next_col, next_fcol)} > {F._MAX_REC_COLS})")
    specs, _ = F.plan_fields(ops)
    for sp in specs:  # the voxel grids go to the device now, in set-up
        if sp["kind"] == "voxel":
            FL.grid_on(sp, state.device)

    # const-norm fast path: |dr| = speed * dt, valid iff exactly one
    # kinematics step precedes every |dr| consumer (the collision
    # probability of every scatter op, the interface's step remainder),
    # every emitter precedes it (a photon emitted after kinematics carries
    # dr = 0 until the next iteration), no dr modifier (a reflection's fold,
    # an interface's kink) lies between them, no interface rescales speeds
    # (match_speed), no field push changes them (lorentz, its q/m = 0 form
    # included, as in the JAX prover), and every particle, emitted ones
    # included, moves at one common speed that each resample (scatter,
    # re-emission) matches. The JAX prover leaves "phase" out of both lists
    # although its op reads |dr|; the port counts it, as it counts "hg".
    const_speed = None
    kin_positions = [i for i, op in enumerate(ops) if op.kind == "kin"]
    scatter_positions = [i for i, op in enumerate(ops)
                         if op.kind in ("del", "iso", "hg", "rayl", "phase",
                                        "compton", "pol", "polc",
                                        "fresnel")]
    emit_positions = [i for i, op in enumerate(ops) if op.kind == "emit"]
    reflect_positions = [i for i, op in enumerate(ops)
                         if op.kind in ("reflect", "fresnel")]
    if (len(kin_positions) == 1 and scatter_positions
            and all(p > kin_positions[0] for p in scatter_positions)
            and all(p < kin_positions[0] for p in emit_positions)
            and not any(kin_positions[0] < q < p for q in reflect_positions
                        for p in scatter_positions)
            and not any(op.kind in ("lorentz", "custom")
                        or (op.kind == "fresnel" and op.iface[4])
                        for op in ops)):
        speeds = [float(np.linalg.norm(np.asarray(
            raw_code_value(o.v), np.float64).reshape(3)))
            for o in objects]
        for b in bulks:
            if isinstance(b["v"], torch.Tensor):
                # device bulk: reduce on the device, fetch two scalars
                norms = torch.sqrt((b["v"].to(torch.float32) ** 2).sum(0))
                speeds += torch.stack([norms.min(),
                                       norms.max()]).double().tolist()
            else:
                norms = np.linalg.norm(np.asarray(b["v"], np.float64),
                                       axis=0)
                speeds += [float(norms.min()), float(norms.max())]
        for op in ops:  # emitted photons join the population at these speeds
            if op.kind == "emit":
                speeds.append(op.c_val if op.emit_v is None
                              else float(np.linalg.norm(op.emit_v)))
        if speeds:
            s0 = speeds[0]
            ok = s0 > 0 and max(abs(s - s0) for s in speeds) <= 1e-4 * s0
            for op in ops:
                if ((op.kind in ("iso", "hg", "rayl", "phase", "compton",
                                 "pol", "polc")
                     or (op.kind == "del" and op.fluor))
                        and abs(op.c_val - s0) > 1e-5 * s0):
                    ok = False
            if ok:
                const_speed = s0

    hint = getattr(sim.exit, "exit_mode_hint", None)
    if hint == "t" or (hint is None and _probe_t_only(sim.exit)):
        exit_mode = "t"
    elif hint == "n0" or (hint is None and _probe_extinction(sim.exit)):
        exit_mode = "n0"
        if not any(op.kind in ("del", "absorb", "custom") for op in ops):
            _no("extinction-without-death", "extinction exit but no step can "
                "remove photons (no ScatterDelete/AbsorbingBoundary/"
                "ElementwiseStep): the run would never terminate")
        if emit_positions:
            _no("extinction-with-emitter", "extinction exit + "
                "PhotonEmitterStep: in-kernel emissions past the extinction "
                "iteration cannot be rolled back; use a t-based exit "
                "(Simulation(until_t=...)) with emitters")
    else:
        _no("exit-predicate", f"exit predicate "
            f"{getattr(sim.exit, '__name__', repr(sim.exit))} is neither "
            "t-only nor extinction-shaped on host probes; declare intent "
            "with Simulation(until_t=...) or Simulation(exit='extinction')")

    chunk = int(sim.chunk_steps) if sim.chunk_steps else 1024
    emit_total = sum(op.emit_n for op in ops if op.kind == "emit")
    if emit_total:
        # one chunk's emissions must fit in half the arena, or emission
        # starves mid-chunk before the engine can recycle slots
        chunk = max(1, min(chunk, (state.capacity // 2) // emit_total))
    stream_every, stream_dtype = 1, "float32"
    if next_plane:
        # the kernel's stream stride: the gcd of every trace step's period
        # (a captured energy plane is per iteration, so it forces 1); a
        # trace step whose period exceeds the stride subsamples on the host
        periods = [m["every"] for m in rec_map if m["kind"] == "trace"]
        has_ecap = any(p >= 0 for m in rec_map
                       for p in m.get("ecap_planes", ()))
        if has_ecap:
            periods.append(1)
        stream_every = math.gcd(*periods)
        # bfloat16 only when every trace step opts in and no captured
        # energies share the buffer
        if not has_ecap and all(s.trace_dtype == "bfloat16" for s in steps
                                if type(s) is TracePathMeasureStep):
            stream_dtype = "bfloat16"
        # one dispatch's stream buffer stays within the record budget
        elem = 2 if stream_dtype == "bfloat16" else 4
        row_bytes = max(next_plane * state.capacity * elem, 1)
        budget = int(sim.max_record_bytes)
        chunk = max(1, min(chunk, (budget // row_bytes) * stream_every))
        if stream_every > 1:
            chunk, stream_every = _whole_periods(
                chunk, stream_every, periods, budget, row_bytes)
    notes = []
    # a block's count tile holds chunk x n_cols int32 of shared memory: a
    # chunk over the budget is shortened (the chunk seed follows the chunk
    # index, so parity with the JAX package then needs its chunk_steps set
    # to the same length)
    # (less the binned reduces' share, F.bin_smem_bytes, and the user
    # programs' block phases', F.phase_smem_bytes)
    tile_bytes = (_MAX_REC_TILE_BYTES - F.bin_smem_bytes(ops)
                  - F.phase_smem_bytes(ops))
    tile_chunk = tile_bytes // (next_col * 4)
    if chunk > tile_chunk:
        chunk = max(1, tile_chunk)
        if stream_every > 1:
            chunk, stream_every = _whole_periods(
                chunk, stream_every, periods, budget, row_bytes)
        notes.append(f"chunk {chunk}: record count tile ({next_col} int "
                     f"columns in {tile_bytes} B of shared memory)")
    # the float sums' partials, a [chunk][n_fcols] slice per warp of the
    # launch, stay within the record budget
    part_budget = int(sim.max_record_bytes)
    part_chunk = part_budget // max(1, F.MAX_WARP_SLICES * next_fcol * 4)
    if next_fcol and chunk > part_chunk:
        chunk = max(1, part_chunk)
        if stream_every > 1:
            chunk, stream_every = _whole_periods(
                chunk, stream_every, periods, budget, row_bytes)
        notes.append(f"chunk {chunk}: float record partials ({next_fcol} "
                     f"float columns x {F.MAX_WARP_SLICES} warp slices in "
                     f"{part_budget} B)")
    plan = F.FusedPlan(ops=ops, n_rec_cols=next_col, chunk=chunk,
                       const_norm_speed=const_speed, n_frec_cols=next_fcol,
                       n_stream=next_plane, stream_every=stream_every,
                       stream_dtype=stream_dtype, species=species,
                       extras=tuple(extra_names),
                       extras_writeback=(
                           tuple(b for b in ("stokes", "pol_ref")
                                 if b in pol_wb)
                           + tuple(dict.fromkeys(b for b in user_wb
                                                 if b not in pol_wb))))
    return FusedProvider(sim, plan, rec_map, dt_fn, update_before_kin,
                         measure_after_update, sim.exit, exit_mode, notes)
