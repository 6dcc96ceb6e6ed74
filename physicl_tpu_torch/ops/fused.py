"""Fused multi-iteration transport: the plan, the packed state, the CUDA
kernel's wrapper and its plain PyTorch twin.

Counterpart of ``physicl_tpu/ops/fused.py`` for the ops ``kin``, ``iso``
(with a density field n(r)), ``del`` (with n(r), a cross-section field
A(E), implicit capture, roulette, the exponential transform, fluorescence
and the deposition tally), ``sign`` (counts or weight sums), ``emit``,
``cross`` (with per-photon energy capture), ``absorb``, ``reflect``,
``periodic``, ``sabsorb``, ``scross``, ``trace``, the rotation family
``hg``, ``rayl``, ``phase`` and ``compton`` (cold and thermal electrons,
the Klein-Nishina recoil and its heating tally), ``fresnel``, the Boris
push ``lorentz``, the polarized scatters ``pol`` (Rayleigh) and ``polc``
(Compton), the Stokes tally ``polmeas`` and the column-0 alive count. One
chunk runs ``k_act`` whole simulation iterations over a packed ``(15 +
n_extras, C)`` float32 state (the core planes, then the plan's extras: the
Stokes and frame rows first, at fixed places, then the ``otype`` plane of
a mixed population, whose photon ops act only on its photons, and the
derived ``qm`` plane) and returns
per-iteration int32 and float32 record rows ``(chunk, 128)`` each, and,
for plans with stream planes (``trace`` positions, captured energies), a
``(ceil(chunk / stream_every), n_stream, C)`` stream buffer: row ``m``
holds iteration ``m * stream_every``, every row at or past
``ceil(k_act / stream_every)`` is NaN. Fields are the callables of
:mod:`physicl_tpu_torch.ops.fields`: the twin calls them, the kernel
evaluates their specs.

* On a CUDA tensor :func:`fused_chunk` launches the hand-written kernel
  ``csrc/fused_transport.cu`` (:func:`fused_transport`) or raises.
* On a CPU tensor it runs :func:`fused_chunk_reference`, the plain PyTorch
  transcription of the JAX package's ``_build_emulated_chunk`` +
  ``_emit_iteration``.

Both draw from the JAX emulated chunk's murmur3 counter hash, keyed on
(chunk seed, iteration, per-iteration draw index, row = slot // 128,
lane = slot % 128), in the JAX draw order. The JAX package's CPU path is
therefore a draw-for-draw oracle for the twin, and the twin one for the
kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional

import numpy as np
import torch

from physicl_tpu_torch.ops import fields as FL
from physicl_tpu_torch.ops.planck import poly_icdf_reference
from physicl_tpu_torch.state import OBJ_PHOTON, SimState, mod_floor

# Field planes in the packed (NF, C) state array (same order as the JAX
# package, so packed states compare plane by plane).
(_RX, _RY, _RZ, _DRX, _DRY, _DRZ, _VX, _VY, _VZ, _DVX, _DVY, _DVZ, _E,
 _ALIVE, _W) = range(15)
_NF = 15
# FusedPlan.species of a population that mixes photons with other particles
SPECIES_MIXED = -1

_LANE = 128
_MAX_REC_COLS = 128
_MASK = 0xFFFFFFFF

# op kinds of the CUDA kernel (csrc/plan.cuh: OpKind)
OP_CODES = {"kin": 0, "del": 1, "iso": 2, "sign": 3, "emit": 4, "cross": 5,
            "absorb": 6, "reflect": 7, "periodic": 8, "sabsorb": 9,
            "scross": 10, "trace": 11, "hg": 12, "rayl": 13, "phase": 14,
            "compton": 15, "fresnel": 16, "lorentz": 17, "pol": 18,
            "polc": 19, "polmeas": 20, "custom": 21, "reduce": 22,
            "kstate": 23}
# the polarization ops (codes 18-20)
_POL_OPS = ("pol", "polc", "polmeas")
# kernel 1i: recorded user programs (ops/record.py), compiled into the
# plan's form library (ops/codegen.py; codes 21-23)
USER_OPS = ("custom", "reduce", "kstate")
# Op::flag bit of a binned reduce (csrc/plan.cuh: kUserBinned; bit 0 is a
# user op's "after the update")
USER_BINNED = 2
_POL_BASES = ("stokes", "pol_ref")
# the Stokes and frame rows, packed first among the extras: the kernel reads
# Stokes at extras 0-2 and the frame at 3-5
POL_ROWS = ("stokes:0", "stokes:1", "stokes:2",
            "pol_ref:0", "pol_ref:1", "pol_ref:2")
# azimuth bisection depths: "pol" under packed angles (its 16-bit draw),
# "polc" (a full-width draw)
POL_ITERS, POLC_ITERS = 17, 26
# the op-sequence instantiations (csrc/fused_transport.cu, fused_seq_kernel):
# the main library's variant of each op sequence compiled with its ops
# fixed; every other plan runs its form's library, whose launch takes
# variant FORM_VARIANT
SEQ_VARIANTS = {("kin", "iso", "sign"): 64, ("kin", "del", "sign"): 65}
FORM_VARIANT = -1
# the dynamic shared memory one block may take (227 KB), and an op-sequence
# launch's share of it per iteration: a 16 B count row and a 16 B entry
# (csrc/fused_transport.cu: seq_smem_bytes); a form launch takes a 4 B count
# per int record column and iteration (form_smem_bytes)
MAX_SMEM_BYTES = 232_448
SEQ_SMEM_PER_ITER = 32
# the float sums' partials: a [k_act][n_fcols] float32 slice per warp of the
# launch; at most 132 SMs x 8 blocks x 8 warps on an H100
MAX_WARP_SLICES = 132 * 8 * 8
MAX_EXTRAS = 8    # extras planes (1h's Stokes and frame rows, otype, qm)
_NAN = float("nan")


@dataclasses.dataclass(frozen=True)
class Bins:
    """A binned reduce's bins (kernel 1i: ``light.SpectrumMeasureStep`` and
    ``MeshTallyStep``, lowered by the prover): ``edges`` the float32
    values the reference's comparisons use (its float64 edges rounded once
    to float32, as a float32 coordinate compared with a Python float rounds
    them), the capture bins, and ``count`` (each slot adds 1; else its
    value, the op program's second output). Its float columns: the bins,
    then underflow, then overflow."""

    edges: tuple
    underflow: bool = False
    overflow: bool = False
    count: bool = True

    @property
    def n_cols(self) -> int:
        return len(self.edges) - 1 + self.underflow + self.overflow

    @property
    def levels(self) -> int:
        """The search's depth: the least L with 2**L - 1 >= the edges."""
        return len(self.edges).bit_length()

    def search_table(self) -> np.ndarray:
        """The edges in the kernel's search order (``csrc/binned.cuh``):
        a complete binary search tree of ``2**levels - 1`` nodes laid out
        level by level (node i's children 2i + 1 and 2i + 2), its in-order
        sequence the edges, then NaN (which no coordinate is at or above);
        float32."""
        n = (1 << self.levels) - 1
        ordered = np.full(n, np.nan, np.float32)
        ordered[:len(self.edges)] = self.edges
        table = np.empty(n, np.float32)
        nxt = iter(ordered)

        def walk(i):
            if i < n:
                walk(2 * i + 1)
                table[i] = next(nxt)
                walk(2 * i + 2)

        walk(0)
        return table


@dataclasses.dataclass
class _Op:
    kind: str                       # a key of OP_CODES
    coef: float = 0.0               # folded A*n (del/iso)
    wl_base: Optional[float] = None  # lambda^-4 folding base (iso)
    c_val: float = 0.0              # |v| of resampled / emitted photons
    # sign: (n_col or -1, first sign col), float columns when weighted;
    # cross: (n_col or -1,); del: (deposition float col,) or ()
    cols: tuple = ()
    # del/iso: density field n(r); del: cross-section field A(E) (field
    # callables of ops/fields with a kernel spec)
    n_fn: Optional[Callable] = None
    a_fn: Optional[Callable] = None
    implicit_capture: bool = False  # del: w *= 1 - p instead of killing
    roulette: tuple = ()            # del: (w_min, w_survive) or ()
    bounds: tuple = ()              # absorb/reflect/periodic: ((lo, hi), ...)
    # sabsorb/scross: (cx, cy, cz, R); sabsorb kills entrants instead of
    # leavers when ``inside``
    sphere: tuple = ()
    inside: bool = False
    # trace: positions in stream planes [stream0, stream0 + 3), and with
    # stream_scat the scatter-event flags in plane stream0 + 3; sampled
    # every stream_every-th iteration (the plan's stride divides it)
    stream0: int = -1
    stream_scat: bool = False
    stream_every: int = 1
    # cross: ((axis, L, col, e_col[, ecap]), ...); col indexes the float
    # records when weighted (a weight sum), else the int records (a count);
    # e_col is a float column for the energy sum, or -1; ecap a stream
    # plane for the crossing photons' energies (NaN elsewhere), or -1
    axes: tuple = ()
    weighted: bool = False
    # emit: photons appear in slots [emit_starts[emit_row, k], +emit_n) each
    # iteration (host-scheduled from the spawn mark)
    emit_n: int = 0
    emit_E: float = 0.0             # constant emitted energy (code units)
    # sampled energies: ops/planck.icdf_table of a PlanckSampler, and the
    # code-unit factor applied to its output
    emit_table: Optional[np.ndarray] = None
    emit_scale: float = 1.0
    emit_r: tuple = (0.0, 0.0, 0.0)
    emit_v: Optional[tuple] = None  # None => isotropic at c_val
    emit_row: int = 0
    # del: exponential transform (b, dx, dy, dz): the kill probability is
    # biased to p (1 - b mu), mu = dr_hat . d, survivors carry (1-p)/(1-p')
    stretch: tuple = ()
    # del: fluorescent re-emission (Y, E_f, E_edge): an absorbed photon with
    # E >= E_edge re-emits at E_f, true-isotropically at c_val, with
    # probability Y
    fluor: tuple = ()
    g: float = 0.0                  # hg: the anisotropy <cos theta>
    # phase: the tabulated inverse CDF's knots (light.phase_knots), float32
    # segment starts m0 and slopes dm over uniform-in-u segments; or a
    # recorded inverse CDF u -> cos theta (a field callable over ("u",))
    phase_knots: Optional[tuple] = None
    phase_fn: Optional[Callable] = None
    inv_mec2: float = 0.0           # compton: 1 / (m_e c^2) in code units
    kn_xsec: bool = False           # compton: pcoll *= sigma_KN / sigma_T
    kn_tries: int = 12              # compton: Kahn tries
    theta_e: float = 0.0            # compton: kT_e / m_e c^2 (0 = at rest)
    # fresnel: (axis, loc, n_lo, n_hi, match_speed); c_val is c for the
    # c / n outgoing speeds of match_speed
    iface: tuple = ()
    # lorentz: a species-wide q/m, or (qm_plane >= 0) the packed plane of
    # per-particle q/m; constant fields as 3-tuples (() = none); the dt of
    # the step's place: after the UpdateTimeStep (sched row 3) or before it
    # (row 4)
    qm: float = 0.0
    qm_plane: int = -1
    e_const: tuple = ()
    b_const: tuple = ()
    # lorentz: recorded fields E(r) / B(r), each one field callable over
    # (r0, r1, r2) with three outputs (None = the constant, or none)
    e_fn: Optional[Callable] = None
    b_fn: Optional[Callable] = None
    after_update: bool = True
    # emit: a polarized source's Stokes vector and frame (() = unpolarized:
    # zeroed rows)
    emit_stokes: tuple = ()
    emit_polref: tuple = ()
    # polmeas: <Q> and <U> columns too (cols = (n_col or -1, first float
    # column of the weight, p, V(, Q, U) sums); ``weighted`` weights by w)
    local_qu: bool = False
    # custom/reduce/kstate: the recorded program (ops/record.Program; its
    # loads and stores name packed planes, a reduce's sums name float
    # columns); reduce: cols = (n_col or -1, first float column); t and dt
    # from the schedule rows of ``after_update``
    prog: object = None
    # reduce: a histogram tally's bins (``Bins``): ``prog`` then computes
    # the coordinate (and the value, unless a count) as outputs 0 (and 1),
    # and each slot adds into its bin's column only (a binned reduce)
    bins: Optional[Bins] = None

    @property
    def fld_fns(self) -> tuple:
        """The kernel's ``Op.fld`` callables: a Lorentz op's E and B
        fields, a phase op's recorded inverse CDF first; None where the op
        reads its constant or table."""
        if self.kind == "lorentz":
            return (self.e_fn, self.b_fn)
        return (self.phase_fn, None)


@dataclasses.dataclass
class FusedPlan:
    """Static description of one fused chunk.

    The JAX prover always sets ``packed_angles`` and ``fast_trig``; the port
    implements only that form (theta and phi from one 32-bit draw, 16 bits
    each; polynomial sin/cos renormalized to |v| = c), so it has no flags.
    """

    ops: List[_Op]
    n_rec_cols: int
    chunk: int
    # |dr| == c*dt for every particle: one scalar per iteration replaces the
    # per-photon norm (set by the prover after checking every speed)
    const_norm_speed: Optional[float] = None
    n_frec_cols: int = 0  # float record columns in use
    # stream planes per sampled iteration (trace positions, captured
    # energies), written on iterations k % stream_every == 0 into row
    # k // stream_every, as float32 or (every trace opted in) bfloat16
    n_stream: int = 0
    stream_every: int = 1
    stream_dtype: str = "float32"
    # the population the prover saw: OBJ_PHOTON, OBJ_GENERIC or
    # SPECIES_MIXED (photon ops gated per particle by the "otype" plane)
    species: int = OBJ_PHOTON
    # planes packed after the core 15 (pack_state's names: "qm", "otype",
    # "name:i" rows of a 3-row extras array); the kernel keeps them
    # read-only except in the slots an emit op fills and the planes of
    # ``extras_writeback``
    extras: tuple = ()
    # the extras bases an op mutates ("stokes", "pol_ref" first, then an
    # ElementwiseStep's extras_write bases): the kernel stores their planes
    # for every slot, and unpack_state returns them
    extras_writeback: tuple = ()
    # run an op-sequence instantiation where the plan has its form
    # (kernel_seq); False runs the same plan through its form library, for
    # holding the two against each other
    specialize: bool = True
    # hand the form kernel its Plan in a device buffer even where the Plan
    # fits the kernel's parameters (a Plan past them always goes there:
    # ops/codegen.py:plan_in_buffer), for holding the two routes against
    # each other
    plan_buffer: bool = False
    # the kernel's plan struct and the per-device fit tables, built once
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_emit(self) -> int:
        return sum(1 for op in self.ops if op.kind == "emit")

    @property
    def has_fields(self) -> bool:
        """The plan evaluates n(r), A(E), recorded E/B or inverse-CDF
        fields."""
        return any(op.n_fn is not None or op.a_fn is not None
                   or any(fn is not None for fn in op.fld_fns)
                   for op in self.ops)

    @property
    def kernel_seq(self) -> Optional[tuple]:
        """The op sequence whose compiled instantiation in the main library
        runs this plan, or None (the plan's form library). Exactly the main
        path's plans:
        ``[kin, iso, sign]`` or ``[kin, del, sign]`` (``SEQ_VARIANTS``)
        with the const-norm |dr| = c dt, ``iso`` without lambda^-4
        weighting and ``del`` without variants (capture, roulette,
        stretch, fluorescence, deposition), neither with fields, ``sign``
        counting (not weighted) with its alive column, and no extras,
        stream planes or float records; and a chunk whose iterations'
        shared memory fits a block (at most 7264 iterations: 32 B an
        iteration; the form library takes longer chunks)."""
        kinds = tuple(op.kind for op in self.ops)
        if (not self.specialize or kinds not in SEQ_VARIANTS
                or self.const_norm_speed is None or self.extras
                or self.n_stream or self.n_frec_cols
                or self.chunk * SEQ_SMEM_PER_ITER > MAX_SMEM_BYTES):
            return None
        mid, sign = self.ops[1], self.ops[2]
        if (mid.n_fn is not None or mid.a_fn is not None
                or mid.wl_base is not None or mid.implicit_capture
                or mid.roulette or mid.stretch or mid.fluor or mid.cols):
            return None
        if sign.weighted or sign.cols[0] < 1:
            return None
        return kinds

    @property
    def has_pol(self) -> bool:
        """The plan runs a polarization op, a polarized emitter or writes
        the Stokes or frame planes back."""
        return bool(set(self.extras_writeback) & set(_POL_BASES)) or any(
            op.kind in _POL_OPS or op.emit_stokes for op in self.ops)

    @property
    def has_user(self) -> bool:
        """The plan runs a recorded user program (kernel 1i)."""
        return any(op.kind in USER_OPS for op in self.ops)

    def plane_mask(self, bases) -> int:
        """Bit ``j`` for each extras plane ``j`` of one of ``bases``."""
        return sum(1 << j for j, name in enumerate(self.extras)
                   if name.split(":")[0] in bases)

    @property
    def n_planes(self) -> int:
        """Rows of the packed state: the 15 core planes and the extras."""
        return _NF + len(self.extras)

    @property
    def n_stream_rows(self) -> int:
        """Rows of the stream buffer: ``ceil(chunk / stream_every)``."""
        return -(-self.chunk // max(1, int(self.stream_every)))

    @property
    def stream_torch_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.stream_dtype == "bfloat16"
                else torch.float32)


def pcoll_row(plan: FusedPlan, sched: torch.Tensor) -> torch.Tensor:
    """The collision probability of an op-sequence plan's ``iso`` or
    ``del`` at each of the chunk's iterations: ``coef * (const_speed *
    dt)`` in float32 on ``sched``'s device, rounded as the kernel and the
    twin (``dr_norm``) round it. The factors are Python floats already
    rounded to float32 (a product with a scalar rounds as one with a
    float32 tensor), so no host-to-device copy waits for queued chunks."""
    dt = sched[0, :plan.chunk].to(torch.float32)
    return _c32(plan.ops[1].coef) * (_c32(plan.const_norm_speed) * dt)


def scatter_threshold(pcoll: torch.Tensor) -> torch.Tensor:
    """int32 ``T(pcoll)`` with ``(pcoll >= unit24(b)) == ((b >> 8) <= T)``
    for every 32-bit draw ``b`` (``unit24(b) = (b >> 8) * 2**-24``):
    ``floor(pcoll * 2**24)`` for ``0 <= pcoll < 1`` (the product is exact;
    ``-0.0`` gives 0), ``2**24 - 1`` (every draw) for ``pcoll >= 1``, and
    -1 (no draw) for a negative ``pcoll`` or NaN."""
    p = pcoll.to(torch.float32)
    t = torch.floor(p * float(1 << 24))
    t = torch.where(p >= 1.0, float((1 << 24) - 1), t)
    t = torch.where(p >= 0.0, t, -1.0)
    return t.to(torch.int32)


class _HashRng:
    """The JAX emulated chunk's counter hash (``_Rng._hash_bits``) in int64
    with a 32-bit mask after every add and multiply. ``lin`` is the per-slot
    term ``row * 0x85EBCA6B + lane * 0xC2B2AE35`` (mod 2**32), computed once
    per chunk; ``idx`` restarts at 0 every iteration and advances per draw."""

    def __init__(self, seed: int, k: int, lin: torch.Tensor):
        self.h0 = ((seed & _MASK) ^ ((k * 0x9E3779B9) & _MASK))
        self.lin = lin
        self.idx = 0

    def bits(self) -> torch.Tensor:
        self.idx += 1
        return self.bits_at(self.idx)

    def bits_at(self, idx: int) -> torch.Tensor:
        """The hash at draw index ``idx`` (the counter does not move)."""
        h = (self.h0 ^ ((idx * 0x7FEB352D) & _MASK)) + self.lin
        h = h & _MASK
        for mul in (0x85EBCA6B, 0xC2B2AE35):
            h = h ^ (h >> 16)
            h = _mul32(h, mul)
            h = h ^ (h >> 13)
        return h ^ (h >> 16)

    def uniform(self) -> torch.Tensor:
        self.idx += 1
        return self.uniform_at(self.idx)

    def uniform_at(self, idx: int) -> torch.Tensor:
        return (self.bits_at(idx) >> 8).to(torch.float32) * (1.0 / (1 << 24))

    def uniform_pair(self):
        b = self.bits()
        scale = 1.0 / (1 << 16)
        return ((b >> 16).to(torch.float32) * scale,
                (b & 0xFFFF).to(torch.float32) * scale)


def _mul32(h: torch.Tensor, mul: int) -> torch.Tensor:
    """``h * mul mod 2**32`` for h < 2**32 without int64 overflow: the
    multiplier is split into 16-bit halves (each product < 2**48)."""
    lo = h * (mul & 0xFFFF)
    hi = ((h * (mul >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _slot_term(gid: torch.Tensor) -> torch.Tensor:
    row, lane = gid // _LANE, gid % _LANE
    return (row * 0x85EBCA6B + lane * 0xC2B2AE35) & _MASK


def _fast_sinpi(y):
    """sin(pi*y) for y in [-1, 1]: parabola + refinement, ~1.1e-3 abs error."""
    p = 4.0 * y * (1.0 - y.abs())
    return p * (0.775 + 0.225 * p.abs())


def _wrap1(x):
    """Map x in [0, 2) (one sine period in pi-units) into [-1, 1)."""
    return x - torch.where(x > 1.0, 2.0, 0.0)


def _fast_angles(tu, pu):
    """(sin, cos) of theta=2*pi*tu and phi=pi*pu for tu,pu in [0,1)."""
    two_tu = 2.0 * tu
    sin_t = _fast_sinpi(_wrap1(two_tu))
    cos_t = _fast_sinpi(_wrap1(two_tu + 0.5))
    sin_p = _fast_sinpi(pu)
    cos_p = _fast_sinpi(_wrap1(pu + 0.5))
    return sin_t, cos_t, sin_p, cos_p


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as the kernel's ``sqrtf``.
    torch's vectorised float32 sqrt on the CPU is not (it misses by one ulp
    on ~0.5% of inputs with AVX512); the float64 root rounds back to the
    correctly rounded float32 one on every device."""
    return torch.sqrt(x.double()).float()


def _f32(x: float) -> torch.Tensor:
    """A float32 scalar constant, rounded once as ``jnp.float32(x)`` is."""
    return torch.tensor(x, dtype=torch.float32)


def _c32(x: float) -> float:
    """``x`` rounded to float32 and back: a Python scalar that a float32
    tensor op uses exactly (decimal -> float64 -> float32, as numpy and the
    kernel's ``(float)`` casts of double literals round it)."""
    return float(np.float32(x))


# Chebyshev-node least-squares fit (degree 8) of log2(1 + t) on [0, 1), max
# abs error 4.9e-8 (the JAX package's coefficients, physicl_tpu/ops/fused.py)
_LOG2_MANT_COEF = (
    4.8863580577762396e-08, 1.4426867778259698, -0.7211146144034414,
    0.4783235448682019, -0.34599601243509254, 0.23923166297596724,
    -0.1345342542024613, 0.05027750737261643, -0.008874696651710342)

# degree-5 fit of 2^t on [0, 1), max rel error 1.0e-7
_EXP2_FRAC_COEF = (
    0.9999998957631349, 0.6931546200033143, 0.24014077009166834,
    0.05586328265986017, 0.008946214665550255, 0.0018951072913389714)


def _horner(coef, t):
    """``sum coef[i] t^i`` in float32 Horner form, highest degree first,
    each product and sum rounded on its own."""
    p = torch.full_like(t, _c32(coef[-1]))
    for c in coef[-2::-1]:
        p = p * t + _c32(c)
    return p


def _fast_log2(x):
    """``log2 x`` for positive normal float32 ``x`` with no transcendental:
    ``x = m 2^e`` by exponent-field extraction (bit casts), then ``e + log2
    m`` with the degree-8 mantissa polynomial (abs err ~4.9e-8)."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m_bits = (bits & 0x007FFFFF) | (127 << 23)
    t = m_bits.view(torch.float32) - 1.0
    return e.to(torch.float32) + _horner(_LOG2_MANT_COEF, t)


def _fast_exp2(x):
    """``2^x`` for float32 ``x`` in (-126, 127) with no transcendental:
    ``x = n + f`` (floor and fraction), the degree-5 polynomial of ``2^f``
    (rel err 1.0e-7) times ``2^n`` built in the exponent field (exact)."""
    n = torch.floor(x)
    p = _horner(_EXP2_FRAC_COEF, x - n)
    # (int32(n) + 127) << 23 with the int32 wrap of the JAX form
    nb = ((n.to(torch.int64) + 127) << 23) & _MASK
    nb = torch.where(nb >= 1 << 31, nb - (1 << 32), nb)
    return p * nb.to(torch.int32).view(torch.float32)


def _fast_neg2log(u):
    """``-2 ln u`` for float32 ``u`` in (0, 1] through :func:`_fast_log2`
    (abs err ~7e-8 in ln, the Maxwell speed tail kept exact)."""
    return _c32(-2.0 * np.log(2.0)) * _fast_log2(u)


def _kn_triples(rng, tries):
    """The Klein-Nishina Kahn tries' draws, ``tries`` times a uniform ``r1``
    then a 16+16-bit pair ``(r2, r3)`` (the JAX fused kernel's
    ``_kn_triples`` under packed angles)."""
    triples = []
    for _ in range(tries):
        r1 = rng.uniform()
        r2, r3 = rng.uniform_pair()
        triples.append((r1, r2, r3))
    return triples


def _kn_cos_eta_fused(alpha, rng, tries):
    """The fused kernel's Klein-Nishina sampler: the tries' draws, then
    ``light._kn_cos_eta`` with the polynomial log2/exp2 forms."""
    from physicl_tpu_torch.light import _kn_cos_eta

    return _kn_cos_eta(alpha, _kn_triples(rng, tries), fast=True)


def _rsqrt_max(x):
    """``rsqrt(max(x, 1e-30))`` as the kernel spells it: ``1 / sqrtf``,
    both correctly rounded (``torch.maximum`` keeps a NaN, as
    ``jnp.maximum`` does)."""
    return 1.0 / _sqrt_rn(torch.maximum(x, _f32(1e-30).to(x.device)))


def _unit_dir(f):
    """Unit velocity direction from the packed planes."""
    inv_v = _rsqrt_max(f[_VX] * f[_VX] + f[_VY] * f[_VY] + f[_VZ] * f[_VZ])
    return f[_VX] * inv_v, f[_VY] * inv_v, f[_VZ] * inv_v


@functools.lru_cache(maxsize=None)
def rot_table():
    """``(sd, cd)``: float32 ``sin`` and ``cos`` of ``2 delta_k = 2 pi /
    2**k`` for k = 0 .. POLC_ITERS, computed in float64 and rounded once,
    as the JAX package folds them into its kernel. The bisection rotates
    its carried double angle by them; the CUDA kernel takes the same table
    in its plan."""
    # scalar float64 sines, one per step, exactly as the JAX trace computes
    # them (a vectorized numpy sine may round differently)
    two_delta = [2.0 * (np.pi / (1 << k)) for k in range(POLC_ITERS + 1)]
    return (np.array([np.sin(x) for x in two_delta], np.float32),
            np.array([np.cos(x) for x in two_delta], np.float32))


def _bisect_phi_sincos(u, a, b, iters: int = POLC_ITERS):
    """``(sin phi, cos phi, sin 2phi, cos 2phi)`` of the polarized azimuth:
    ``phi + (a/2) sin 2phi + (b/2)(1 - cos 2phi) = 2 pi u`` solved on [0, 2
    pi] by ``iters`` monotone bisection steps in float32 (the JAX kernel's
    ``_bisect_phi_sincos``). The pair ``(sin 2 lo, cos 2 lo)`` is carried
    and rotated by :func:`rot_table`'s constants, so that no step takes a
    transcendental; the ``b/2`` term is folded into the target. The
    half-angle pair comes once at the end, from the well-conditioned root
    and a division by the larger component, with signs from the interval's
    end."""
    sd_t, cd_t = rot_table()
    half = _c32(0.5)
    ha = half * a
    hb = half * b
    target = u * _c32(2.0 * np.pi) - hb
    lo = torch.zeros_like(u)
    s2 = torch.zeros_like(u)   # sin 2 lo
    c2 = torch.ones_like(u)    # cos 2 lo
    for k in range(iters):
        mid = lo + _c32(np.pi / (1 << k))
        if k == 0:  # the rotation by 2 pi is the identity
            s2_m, c2_m = s2, c2
        else:
            sd, cd = float(sd_t[k]), float(cd_t[k])
            s2_m = s2 * cd + c2 * sd
            c2_m = c2 * cd - s2 * sd
        fv = (mid + ha * s2_m) - hb * c2_m
        go_hi = fv < target
        lo = torch.where(go_hi, mid, lo)
        s2 = torch.where(go_hi, s2_m, s2)
        c2 = torch.where(go_hi, c2_m, c2)
    # the final midpoint: one more half-interval rotation
    sd, cd = float(sd_t[iters]), float(cd_t[iters])
    s2_f = s2 * cd + c2 * sd
    c2_f = c2 * cd - s2 * sd
    phi = lo + _c32(np.pi / (1 << iters))
    inv = _rsqrt_max(s2_f * s2_f + c2_f * c2_f)
    s2_f = s2_f * inv
    c2_f = c2_f * inv
    big_c = c2_f >= 0
    cp_mag = _sqrt_rn((1.0 + c2_f) * half)
    sp_mag = _sqrt_rn((1.0 - c2_f) * half)
    sign_c = torch.where((phi < _c32(0.5 * np.pi))
                         | (phi > _c32(1.5 * np.pi)), 1.0, -1.0)
    sign_s = torch.where(phi < _c32(np.pi), 1.0, -1.0)
    cp_big = sign_c * cp_mag
    sp_big = sign_s * sp_mag
    hs2 = s2_f * half
    cos_p = torch.where(big_c, cp_big, hs2 / torch.where(big_c, 1.0, sp_big))
    sin_p = torch.where(big_c, hs2 / torch.where(big_c, cp_big, 1.0), sp_big)
    return sin_p, cos_p, s2_f, c2_f


def _field_index(ops):
    """The distinct field specs the ops use, in first-use order (an op's
    n(r), A(E), then its ``fld_fns``), and a map from each spec's id to its
    index."""
    specs, index = [], {}
    for op in ops:
        for fn in (op.n_fn, op.a_fn) + op.fld_fns:
            if fn is None:
                continue
            spec = getattr(fn, "spec", None)
            if spec is None:
                raise NotImplementedError("a Python field callable cannot "
                                          "be inlined into the kernel")
            if id(spec) not in index:
                index[id(spec)] = len(specs)
                specs.append(spec)
    return specs, index


def _slot(index, fn) -> int:
    return -1 if fn is None else index[id(fn.spec)]


def plan_fields(ops):
    """The distinct field specs the ops use, in first-use order (one kernel
    field each: ops sharing a callable share its entry and its device
    grid), and each op's ``(n field, A field)`` indices (-1 = none)."""
    specs, index = _field_index(ops)
    return specs, [(_slot(index, op.n_fn), _slot(index, op.a_fn))
                   for op in ops]


def _check_plan(plan: FusedPlan) -> None:
    for op in plan.ops:
        if op.kind not in OP_CODES:
            raise NotImplementedError(f"fused op {op.kind!r} is not ported")
        if op.kind == "phase" and (op.phase_knots is None) == (
                op.phase_fn is None):
            raise ValueError("a phase op needs its knot table "
                             "(light.phase_knots) or a recorded inverse CDF")
        if op.kind == "compton" and op.kn_tries < 1:
            raise ValueError("compton needs kn_tries >= 1")
    if len(plan.extras) > MAX_EXTRAS:
        raise ValueError(f"{len(plan.extras)} extras planes exceed the "
                         f"kernel's {MAX_EXTRAS}")
    if (plan.species == SPECIES_MIXED) != ("otype" in plan.extras):
        raise ValueError("a mixed plan, and only a mixed plan, packs the "
                         "otype plane")
    for op in plan.ops:
        if op.kind == "lorentz" and not (
                op.qm_plane < 0 or _NF <= op.qm_plane < plan.n_planes):
            raise ValueError(f"lorentz reads plane {op.qm_plane} of "
                             f"{plan.n_planes}")
    _check_pol(plan)
    _check_user(plan)
    for op in plan.ops:
        for fn, n_out in zip(op.fld_fns, (3, 3) if op.kind == "lorentz"
                             else (1, 1)):
            if fn is not None and fn.spec.get("n_out", 1) != n_out:
                raise ValueError(f"{op.kind} needs fields of {n_out} "
                                 "outputs")
    if plan.stream_every < 1 or plan.stream_dtype not in ("float32",
                                                          "bfloat16"):
        raise ValueError("stream_every must be >= 1 and stream_dtype "
                         "float32 or bfloat16")
    for op in plan.ops:
        planes = ([op.stream0 + d for d in range(3 + op.stream_scat)]
                  if op.kind == "trace"
                  else [_axis(ax)[4] for ax in op.axes])
        if any(p >= plan.n_stream or (op.kind == "trace" and p < 0)
               for p in planes):
            raise ValueError(f"{op.kind} writes stream planes {planes} but "
                             f"the plan has {plan.n_stream}")


def _check_pol(plan: FusedPlan) -> None:
    """The polarization ops' layout contract with the kernel: the Stokes
    rows lead the extras, the frame rows follow where an op needs them,
    and an op that mutates them has them written back."""
    both = plan.extras[:6] == POL_ROWS
    for op in plan.ops:
        if op.kind in ("pol", "polc") or op.emit_stokes:
            if not both:
                raise ValueError(f"{op.kind} needs extras {POL_ROWS} first "
                                 f"(got {plan.extras})")
            if not {"stokes", "pol_ref"} <= set(plan.extras_writeback):
                raise ValueError(f"{op.kind} mutates the Stokes and frame "
                                 "planes: both need write-back")
            if op.kind == "emit" and (len(op.emit_stokes) != 3
                                      or len(op.emit_polref) != 3):
                raise ValueError("a polarized emit needs 3 Stokes and 3 "
                                 "frame values")
        if op.kind == "polmeas" and plan.extras[:3] != POL_ROWS[:3]:
            raise ValueError(f"polmeas needs extras {POL_ROWS[:3]} first")
        if op.fluor:
            bases = {n.split(":")[0] for n in plan.extras} & {"stokes",
                                                              "pol_ref"}
            if not bases <= set(plan.extras_writeback):
                raise ValueError("fluorescence zeroes the Stokes and frame "
                                 "planes: they need write-back")
    for base in plan.extras_writeback:
        if not any(n.split(":")[0] == base for n in plan.extras):
            raise ValueError(f"write-back of {base!r}, which is not packed")


def _check_user(plan: FusedPlan) -> None:
    """Kernel 1i's layout: loads of packed planes, stores to the core planes
    (not ``alive``) or to written-back extras, record sums into the plan's
    float columns, registers within the program's file."""
    from physicl_tpu_torch.ops import record as RC

    user_planes = plan.plane_mask(plan.extras_writeback)
    for op in plan.ops:
        if op.kind not in USER_OPS:
            continue
        prog = op.prog
        if prog is None:
            raise ValueError(f"{op.kind} needs its recorded program")
        if op.bins is not None:
            _check_binned(plan, op)
            continue
        for code, d, a, b, y, bimm in prog.ins:
            if max(d, a, b) >= prog.n_regs or (
                    code == RC.U_SEL and not bimm and y >= prog.n_regs):
                raise ValueError("a user program names a register past its "
                                 "file")
            if code == RC.U_LD and not 0 <= y < plan.n_planes:
                raise ValueError(f"a user program loads plane {y} of "
                                 f"{plan.n_planes}")
            if code == RC.U_ST and not (
                    (0 <= y < _NF and y != _ALIVE)
                    or (y >= _NF and (user_planes >> (y - _NF)) & 1)):
                raise ValueError(f"a user program stores plane {y}, which "
                                 "is neither a core plane nor written back")
            if code == RC.U_ACC and not 0 <= y < plan.n_frec_cols:
                raise ValueError(f"a user program sums into float column "
                                 f"{y} of {plan.n_frec_cols}")


def _check_binned(plan: FusedPlan, op: _Op) -> None:
    """A binned reduce's program computes its outputs (the coordinate, and
    the value unless a count) from packed planes, without draws or effects;
    its edges are at least two and non-decreasing in float32, and its
    columns within the plan's float columns."""
    from physicl_tpu_torch.ops import record as RC

    bins, n_out = op.bins, 1 + (not op.bins.count)
    if op.kind != "reduce":
        raise ValueError(f"{op.kind} cannot bin: only a reduce does")
    stores = []
    for code, d, a, b, y, bimm in op.prog.ins:
        if code in (RC.U_ALIVE, RC.U_ACC, RC.U_UNIF, RC.U_T, RC.U_DT):
            raise ValueError("a binned reduce's program computes its "
                             "coordinate and value only")
        if code == RC.U_LD and not 0 <= y < plan.n_planes:
            raise ValueError(f"a binned reduce loads plane {y} of "
                             f"{plan.n_planes}")
        if code == RC.U_ST:
            stores.append(y)
    if sorted(stores) != list(range(n_out)):
        raise ValueError(f"a binned reduce's program stores outputs "
                         f"{stores}, not 0..{n_out - 1}")
    e = np.asarray(bins.edges, np.float32)
    if e.size < 2 or not (np.diff(e) >= 0).all():
        raise ValueError("a binned reduce needs >= 2 non-decreasing edges")
    if not 0 <= op.cols[1] <= plan.n_frec_cols - bins.n_cols:
        raise ValueError(f"a binned reduce's {bins.n_cols} columns from "
                         f"{op.cols[1]} pass the plan's {plan.n_frec_cols}")


def bin_smem_floats(ops) -> tuple:
    """``(edges, row)``: the floats of shared memory a block's binned
    reduces take (``csrc/fused_transport.cu``: ``bin_smem``): each op's
    search table, and the widest op's row of columns; each warp then takes
    64 staging words and that row."""
    binned = [op.bins for op in ops if op.bins is not None]
    if not binned:
        return 0, 0
    edges = sum((1 << b.levels) - 1 for b in binned)
    return edges, max(b.n_cols for b in binned)


def bin_smem_bytes(ops) -> int:
    """The bytes of static shared memory a block's binned reduces take
    (the 8 warps of a 256-thread block)."""
    edges, row = bin_smem_floats(ops)
    return 4 * (edges + (8 * (64 + row) if row else 0))


def phase_smem_bytes(ops) -> int:
    """The bytes of dynamic shared memory the user programs' block phases
    take (csrc/phase.cuh: the largest program's, ahead of the count
    tile)."""
    from physicl_tpu_torch.ops import record as RC

    return 4 * max((RC.phase_words(op.prog) for op in ops
                    if op.kind in USER_OPS and op.prog is not None),
                   default=0)


def _axis(ax) -> tuple:
    """A cross op's plane as ``(axis, L, col, e_col, ecap)`` (a 4-tuple
    captures no energies)."""
    return tuple(ax) if len(ax) == 5 else (*ax, -1)


def _emit_rows(emit_starts, plan: FusedPlan):
    """Host int32 (n_emit, >= chunk) copy of the emit schedule."""
    if not plan.n_emit:
        return None
    if emit_starts is None:
        raise ValueError("plan has emit ops but no emit_starts")
    if isinstance(emit_starts, torch.Tensor):
        emit_starts = emit_starts.cpu().numpy()
    rows = np.asarray(emit_starts, np.int64)
    if rows.ndim != 2 or rows.shape[0] < plan.n_emit \
            or rows.shape[1] < plan.chunk:
        raise ValueError(f"emit_starts must be ({plan.n_emit}, chunk), got "
                         f"{rows.shape}")
    return rows


def fused_chunk_reference(packed: torch.Tensor, sched: torch.Tensor,
                          seed: int, k_act: int, plan: FusedPlan,
                          emit_starts=None):
    """Plain PyTorch version of one fused chunk. Returns ``(out, rec,
    rec_f)``: the new packed state (``packed`` is not modified), int32
    records ``(chunk, 128)`` and float32 records of the same shape; plans
    with stream planes add the stream buffer, ``(out, rec, rec_f,
    stream)``. ``emit_starts`` is the ``(n_emit, chunk)`` int32 emit
    schedule (any device or numpy); plans without emit ops need none.

    Runs on any device; :func:`fused_chunk` uses it for CPU tensors only.
    Float records are plain ``torch.sum``s, so they agree with the kernel's
    fixed-order sums to rounding, not bitwise.
    """
    from physicl_tpu_torch import light as lt
    from physicl_tpu_torch.ops import record as RC

    _check_plan(plan)
    starts = _emit_rows(emit_starts, plan)
    dev = packed.device
    C = packed.shape[1]
    f = [packed[i].clone() for i in range(plan.n_planes)]
    # dt at kinematics, after and before the UpdateTimeStep (sched rows 0,
    # 3, 4)
    dts, dts_after, dts_before = (sched[i].to(device=dev,
                                              dtype=torch.float32)
                                  for i in (0, 3, 4))
    # rows 1-4: t after and before the UpdateTimeStep, then dt after and
    # before (the user programs' t and dt)
    sched_t = [sched[i].to(device=dev, dtype=torch.float32)
               for i in (1, 2, 3, 4)]
    p_otype = (_NF + plan.extras.index("otype")
               if plan.species == SPECIES_MIXED else -1)
    rec = torch.zeros((plan.chunk, _MAX_REC_COLS), dtype=torch.int32,
                      device=dev)
    rec_f = torch.zeros((plan.chunk, _MAX_REC_COLS), dtype=torch.float32,
                        device=dev)
    gid = torch.arange(C, dtype=torch.int64, device=dev)
    lin = _slot_term(gid)
    speed = (None if plan.const_norm_speed is None
             else _f32(plan.const_norm_speed).to(dev))
    consts = [(_f32(op.coef).to(dev), _f32(op.c_val).to(dev),
               None if op.wl_base is None else _f32(op.wl_base).to(dev))
              for op in plan.ops]
    tables = [None if op.emit_table is None
              else torch.from_numpy(op.emit_table).to(dev)
              for op in plan.ops]
    one = _f32(1.0).to(dev)
    roulettes = [tuple(_f32(x).to(dev) for x in op.roulette)
                 for op in plan.ops]
    boxes = [tuple((_f32(lo).to(dev), _f32(hi).to(dev))
                   for lo, hi in op.bounds) for op in plan.ops]
    spheres = [tuple(_f32(x).to(dev) for x in op.sphere) for op in plan.ops]
    every = int(plan.stream_every)
    stream = (torch.full((plan.n_stream_rows, plan.n_stream, C), _NAN,
                         dtype=plan.stream_torch_dtype, device=dev)
              if plan.n_stream else None)

    def count(mask):
        return mask.sum(dtype=torch.int32)

    def fsum(mask, val):
        return torch.where(mask, val, 0.0).sum()

    def direction(c_val, tu, pu):
        sin_t, cos_t, sin_p, cos_p = _fast_angles(tu, pu)
        nx, ny, nz = sin_t * cos_p, sin_t * sin_p, cos_t
        # 1/sqrt, both correctly rounded: the kernel spells the same
        cval = c_val * (1.0 / _sqrt_rn(nx * nx + ny * ny + nz * nz))
        return cval * nx, cval * ny, cval * nz

    for k in range(int(k_act)):
        dt = dts[k]
        rng = _HashRng(int(seed), k, lin)
        alive = f[_ALIVE] > 0
        sample = stream is not None and k % every == 0
        planes = [None] * plan.n_stream
        # the photons of a mixed population (None: every slot's species is
        # the plan's)
        is_ph = None if p_otype < 0 else f[p_otype] == OBJ_PHOTON

        def ph_alive():
            return alive if is_ph is None else alive & is_ph

        def dr_norm():
            if speed is not None:
                return speed * dt
            return _sqrt_rn(f[_DRX] * f[_DRX] + f[_DRY] * f[_DRY]
                            + f[_DRZ] * f[_DRZ])

        def n_of(op):
            return op.n_fn(f[_RX], f[_RY], f[_RZ]).to(torch.float32)

        for op, (coef, c_val, wl_base), table, roul, box, sph in zip(
                plan.ops, consts, tables, roulettes, boxes, spheres):
            if op.kind == "kin":
                for d in range(3):
                    dr = f[_VX + d] * dt
                    f[_DRX + d] = dr
                    f[_RX + d] = f[_RX + d] + dr
            elif op.kind == "del":
                pcoll = coef * dr_norm()
                if op.a_fn is not None:  # energy-dependent cross-section
                    pcoll = pcoll * op.a_fn(f[_E]).to(torch.float32)
                if op.n_fn is not None:  # variable number density n(r)
                    pcoll = pcoll * n_of(op)
                if op.implicit_capture:
                    # survival biasing: deterministic weight decay, a draw
                    # only for roulette
                    sel = ph_alive()
                    p = pcoll.clamp(0.0, 1.0)
                    if op.cols:  # deposited energy: exact expectation
                        rec_f[k, op.cols[0]] = fsum(sel, f[_W] * p * f[_E])
                    f[_W] = torch.where(sel, f[_W] * (one - p), f[_W])
                    if op.roulette:
                        w_min, w_sur = roul
                        u = rng.uniform()
                        low = sel & (f[_W] < w_min)
                        kill = low & (u * w_sur >= f[_W])
                        f[_W] = torch.where(low & ~kill, w_sur, f[_W])
                        alive = alive & ~kill
                        f[_ALIVE] = alive.to(torch.float32)
                elif op.stretch:
                    # exponential transform: the kill biased by the
                    # direction cosine, survivors carry the likelihood ratio
                    u = rng.uniform()
                    sel = ph_alive()
                    tiny = _f32(1e-30).to(dev)
                    b, sx, sy, sz = (_c32(x) for x in op.stretch)
                    mu = ((f[_DRX] * sx + f[_DRY] * sy + f[_DRZ] * sz)
                          / torch.maximum(dr_norm(), tiny))
                    p_true = pcoll.clamp(0.0, 1.0)
                    p_bias = (pcoll * (1.0 - b * mu)).clamp(0.0, 1.0)
                    # cap saturating biased kills where p_true < 1 (a
                    # survivor branch must remain): 8x weight at most
                    p_bias = torch.where(
                        p_true < 1.0,
                        torch.minimum(p_bias, _f32(7.0 / 8.0).to(dev)),
                        p_bias)
                    hit = (p_bias >= u) & sel
                    ratio = (1.0 - p_true) / torch.maximum(1.0 - p_bias, tiny)
                    f[_W] = torch.where(sel & ~hit, f[_W] * ratio, f[_W])
                    if op.cols:  # killed photons deposit w E p / p'
                        rec_f[k, op.cols[0]] = fsum(
                            hit, f[_W] * f[_E]
                            * (p_true / torch.maximum(p_bias, tiny)))
                    alive = alive & ~hit
                    f[_ALIVE] = alive.to(torch.float32)
                elif op.fluor:
                    # fluorescence: an absorbed photon above the edge is
                    # re-emitted at the line energy with probability Y
                    u = rng.uniform()
                    hit = (pcoll >= u) & ph_alive()
                    Y, E_f, E_edge = (_c32(x) for x in op.fluor)
                    y = rng.uniform()
                    cu, au = rng.uniform_pair()
                    fluo = hit & (y < Y) & (f[_E] >= E_edge)
                    killed = hit & ~fluo
                    if op.cols:  # all of E for a kill, E - E_f re-emitted
                        rec_f[k, op.cols[0]] = torch.where(
                            killed, f[_W] * f[_E], torch.where(
                                fluo, f[_W] * (f[_E] - E_f), 0.0)).sum()
                    # true isotropic emission: cos theta uniform
                    cos_t = 2.0 * cu - 1.0
                    sin_t = _sqrt_rn((1.0 - cos_t * cos_t).clamp_min(0.0))
                    two_au = 2.0 * au
                    sin_a = _fast_sinpi(_wrap1(two_au))
                    cos_a = _fast_sinpi(_wrap1(two_au + 0.5))
                    n_new = (sin_t * cos_a, sin_t * sin_a, cos_t)
                    cval = c_val * _rsqrt_max(n_new[0] * n_new[0]
                                              + n_new[1] * n_new[1]
                                              + n_new[2] * n_new[2])
                    for d in range(3):
                        old = f[_VX + d]
                        vn = cval * n_new[d]
                        f[_VX + d] = torch.where(fluo, vn, old)
                        # dv only where re-emitted: an upstream scatter's
                        # flags of this iteration survive
                        f[_DVX + d] = torch.where(fluo, vn - old,
                                                  f[_DVX + d])
                    f[_E] = torch.where(fluo, E_f, f[_E])
                    # fluorescence light is unpolarized: the re-emitted
                    # photons' Stokes and frame rows are zeroed
                    for j, name in enumerate(plan.extras):
                        if name.split(":")[0] in ("stokes", "pol_ref"):
                            f[_NF + j] = torch.where(fluo, 0.0, f[_NF + j])
                    alive = alive & ~killed
                    f[_ALIVE] = alive.to(torch.float32)
                else:
                    u = rng.uniform()
                    hit = (pcoll >= u) & ph_alive()
                    if op.cols:  # deposited energy: killed photons' w*E
                        rec_f[k, op.cols[0]] = fsum(hit, f[_W] * f[_E])
                    alive = alive & ~hit
                    f[_ALIVE] = alive.to(torch.float32)
            elif op.kind == "absorb":
                for d, (lo, hi) in enumerate(box):
                    alive = alive & (f[_RX + d] >= lo) & (f[_RX + d] <= hi)
                f[_ALIVE] = alive.to(torch.float32)
            elif op.kind == "periodic":
                # r folds into [lo, hi) by modulo; v and dr untouched
                for d, (lo, hi) in enumerate(box):
                    f[_RX + d] = lo + mod_floor(f[_RX + d] - lo, hi - lo)
            elif op.kind == "reflect":
                # triangle-wave fold of any overshoot; an odd fold count
                # flips the velocity, dr spans old to folded position
                for d, (lo, hi) in enumerate(box):
                    L = hi - lo
                    r0 = f[_RX + d]
                    y = mod_floor(r0 - lo, 2 * L)
                    odd = y > L
                    folded = lo + torch.where(odd, 2 * L - y, y)
                    outside = (r0 > hi) | (r0 < lo)
                    r1 = torch.where(outside, folded, r0)
                    f[_VX + d] = torch.where(outside & odd, -f[_VX + d],
                                             f[_VX + d])
                    f[_DRX + d] = r1 - (r0 - f[_DRX + d])
                    f[_RX + d] = r1
            elif op.kind == "sabsorb":
                # kill leavers of the sphere (entrants when ``inside``)
                cx, cy, cz, R = sph
                dx, dy, dz = f[_RX] - cx, f[_RY] - cy, f[_RZ] - cz
                in_s = dx * dx + dy * dy + dz * dz <= R * R
                alive = alive & (~in_s if op.inside else in_s)
                f[_ALIVE] = alive.to(torch.float32)
            elif op.kind == "scross":
                # the plane tally's endpoint test on |r - c|^2 against R^2
                n_col, col = op.cols
                if n_col >= 0:
                    rec[k, n_col] = count(alive)
                cx, cy, cz, R = sph
                dx1, dy1, dz1 = f[_RX] - cx, f[_RY] - cy, f[_RZ] - cz
                dx0, dy0, dz0 = dx1 - f[_DRX], dy1 - f[_DRY], dz1 - f[_DRZ]
                r1 = dx1 * dx1 + dy1 * dy1 + dz1 * dz1
                r0 = dx0 * dx0 + dy0 * dy0 + dz0 * dz0
                R2 = R * R
                crossed = (((r0 <= R2) & (R2 <= r1))
                           | ((r0 >= R2) & (R2 >= r1))) & alive
                if op.weighted:
                    rec_f[k, col] = fsum(crossed, f[_W])
                else:
                    rec[k, col] = count(crossed)
            elif op.kind == "trace":
                # positions where alive, NaN elsewhere; scatter-event flags
                if sample:
                    for d in range(3):
                        planes[op.stream0 + d] = torch.where(
                            alive, f[_RX + d], _NAN)
                    if op.stream_scat:
                        scat = ((f[_DVX] != 0) | (f[_DVY] != 0)
                                | (f[_DVZ] != 0)) & alive
                        planes[op.stream0 + 3] = scat.to(torch.float32)
            elif op.kind == "iso":
                pcoll = coef * dr_norm()
                if op.n_fn is not None:
                    pcoll = pcoll * n_of(op)
                if wl_base is not None:
                    base = f[_E] * wl_base
                    b2 = base * base
                    pcoll = pcoll * (b2 * b2)
                u = rng.uniform()
                tu, pu = rng.uniform_pair()
                scatter = (pcoll >= u) & ph_alive()
                vnew = direction(c_val, tu, pu)
                for d in range(3):
                    old = f[_VX + d]
                    f[_VX + d] = torch.where(scatter, vnew[d], old)
                    f[_DVX + d] = torch.where(scatter, vnew[d] - old, 0.0)
            elif op.kind == "compton" and op.theta_e > 0.0:
                # thermal electrons: a Maxwell electron, the flux factor on
                # the collision rate, exact Klein-Nishina in its frame
                pcoll = coef * dr_norm()
                if op.n_fn is not None:
                    pcoll = pcoll * n_of(op)
                u = rng.uniform()
                pu = rng.uniform()
                # the Box-Muller radii take full 24-bit draws, the angles
                # the halves of one pair: u4 = (r, a1, r, a2)
                a1, a2 = rng.uniform_pair()
                u4 = (rng.uniform(), a1, rng.uniform(), a2)
                E_new, n_new, alpha1, flux, kn_ok = lt._ic_thermal_scatter(
                    f[_E], _unit_dir(f), op.inv_mec2, op.theta_e, u4,
                    lambda a: _kn_cos_eta_fused(a, rng, op.kn_tries), pu,
                    fast_trig=True)
                pcoll = pcoll * flux
                if op.kn_xsec:
                    pcoll = pcoll * lt._kn_sigma_ratio(alpha1, fast=True)
                scatter = (pcoll >= u) & ph_alive() & kn_ok
                for d in range(3):
                    old = f[_VX + d]
                    vn = n_new[d] * c_val
                    f[_VX + d] = torch.where(scatter, vn, old)
                    f[_DVX + d] = torch.where(scatter, vn - old, 0.0)
                if op.cols:  # net energy to the electrons (signed)
                    rec_f[k, op.cols[0]] = fsum(scatter,
                                                f[_W] * (f[_E] - E_new))
                f[_E] = torch.where(scatter, E_new, f[_E])
            elif op.kind in ("hg", "rayl", "phase", "compton"):
                # anisotropic scatter: the iso collision model, the new
                # direction drawn relative to the incoming one; compton
                # adds the Klein-Nishina angle and the recoil E' = E / eta
                pcoll = coef * dr_norm()
                if op.n_fn is not None:
                    pcoll = pcoll * n_of(op)
                if wl_base is not None:
                    base = f[_E] * wl_base
                    b2 = base * base
                    pcoll = pcoll * (b2 * b2)
                eta = None
                if op.kind == "compton":
                    alpha = f[_E] * _c32(op.inv_mec2)
                    if op.kn_xsec:
                        pcoll = pcoll * lt._kn_sigma_ratio(alpha, fast=True)
                    u = rng.uniform()
                    pu = rng.uniform()
                    cos_t, eta, kn_ok = _kn_cos_eta_fused(alpha, rng,
                                                          op.kn_tries)
                    scatter = (pcoll >= u) & ph_alive() & kn_ok
                else:
                    u = rng.uniform()
                    cu, pu = rng.uniform_pair()
                    scatter = (pcoll >= u) & ph_alive()
                if op.kind == "phase" and op.phase_fn is not None:
                    cos_t = op.phase_fn(cu).to(torch.float32).clamp(-1.0,
                                                                    1.0)
                elif op.kind == "phase":
                    cos_t = lt.phase_icdf(cu, *op.phase_knots).clamp(-1.0,
                                                                    1.0)
                elif op.kind == "rayl":
                    cos_t = lt._rayleigh_cos_theta(cu, fast=True)
                elif op.kind == "hg" and abs(op.g) < 1e-7:
                    cos_t = 2.0 * cu - 1.0  # the exact isotropic limit
                elif op.kind == "hg":
                    # the scalar factors in float32, as the JAX trace
                    # folds them: (1 - g^2), (1 - g), 2g, (1 + g^2). Both
                    # operands of a divide are tensors: torch divides by a
                    # scalar (or a CPU scalar tensor) on the card as a
                    # product with its reciprocal, rounded twice
                    gg, one = np.float32(op.g), np.float32(1.0)
                    g2 = gg * gg
                    s = (torch.full_like(cu, float(one - g2))
                         / (float(one - gg) + float(gg + gg) * cu))
                    cos_t = ((float(one + g2) - s * s)
                             / _f32(gg + gg).to(dev)).clamp(-1.0, 1.0)
                sin_t = _sqrt_rn((1.0 - cos_t * cos_t).clamp_min(0.0))
                two_pu = 2.0 * pu
                sin_p = _fast_sinpi(_wrap1(two_pu))
                cos_p = _fast_sinpi(_wrap1(two_pu + 0.5))
                # the azimuth pair normalised, so that the sines' error
                # cannot leak into the polar angle
                inv_p = 1.0 / _sqrt_rn(sin_p * sin_p + cos_p * cos_p)
                sin_p, cos_p = sin_p * inv_p, cos_p * inv_p
                n_new = lt._hg_direction(_unit_dir(f), cos_t, sin_t, cos_p,
                                        sin_p)
                cval = c_val * (1.0 / _sqrt_rn(n_new[0] * n_new[0]
                                               + n_new[1] * n_new[1]
                                               + n_new[2] * n_new[2]))
                for d in range(3):
                    old = f[_VX + d]
                    vn = n_new[d] * cval
                    f[_VX + d] = torch.where(scatter, vn, old)
                    f[_DVX + d] = torch.where(scatter, vn - old, 0.0)
                if eta is not None:  # the recoil
                    E_new = f[_E] / eta
                    if op.cols:  # heating: w (E - E') over scatters
                        rec_f[k, op.cols[0]] = fsum(scatter,
                                                    f[_W] * (f[_E] - E_new))
                    f[_E] = torch.where(scatter, E_new, f[_E])
            elif op.kind in ("pol", "polc"):
                # Stokes-polarized scatter: theta from the dipole marginal
                # (pol) or Klein-Nishina (polc), phi | theta by bisection,
                # the Fano matrix with kappa = 2 (pol) or eta + 1/eta, the
                # frame rotated with the direction; every slot keeps its
                # frame re-orthonormalized against v
                pcoll = coef * dr_norm()
                if op.n_fn is not None:
                    pcoll = pcoll * n_of(op)
                eta = None
                if op.kind == "polc":
                    alpha = f[_E] * _c32(op.inv_mec2)
                    if op.kn_xsec:
                        pcoll = pcoll * lt._kn_sigma_ratio(alpha, fast=True)
                    u = rng.uniform()
                    pu = rng.uniform()
                    cos_t, eta, kn_ok = _kn_cos_eta_fused(alpha, rng,
                                                          op.kn_tries)
                    kappa = eta + 1.0 / eta
                    scatter = (pcoll >= u) & ph_alive() & kn_ok
                else:
                    if wl_base is not None:
                        base = f[_E] * wl_base
                        b2 = base * base
                        pcoll = pcoll * (b2 * b2)
                    u = rng.uniform()
                    cu, pu = rng.uniform_pair()
                    kappa = _f32(2.0).to(dev)
                    scatter = (pcoll >= u) & ph_alive()
                st_p, pr_p = _NF, _NF + 3  # POL_ROWS lead the extras
                dx, dy, dz = _unit_dir(f)
                q, u_st, v_st = f[st_p], f[st_p + 1], f[st_p + 2]
                dot = dx * f[pr_p] + dy * f[pr_p + 1] + dz * f[pr_p + 2]
                p0 = f[pr_p] - dot * dx
                p1 = f[pr_p + 1] - dot * dy
                p2 = f[pr_p + 2] - dot * dz
                n2 = p0 * p0 + p1 * p1 + p2 * p2
                inv_n = _rsqrt_max(n2)
                # a degenerate frame (zero-filled rows of a fresh photon):
                # z-hat where |dz| < 0.9, else y-hat, orthonormalized
                use_z = dz.abs() < 0.9
                cy = torch.where(use_z, 0.0, 1.0)
                cz = torch.where(use_z, 1.0, 0.0)
                dotc = dy * cy + dz * cz
                fb0 = -dotc * dx
                fb1 = cy - dotc * dy
                fb2 = cz - dotc * dz
                inv_fb = _rsqrt_max(fb0 * fb0 + fb1 * fb1 + fb2 * fb2)
                degen = n2 < _f32(1e-8).to(dev)
                e1x = torch.where(degen, fb0 * inv_fb, p0 * inv_n)
                e1y = torch.where(degen, fb1 * inv_fb, p1 * inv_n)
                e1z = torch.where(degen, fb2 * inv_fb, p2 * inv_n)
                if op.kind == "pol":
                    cos_t = lt._rayleigh_cos_theta(cu, fast=True)
                c2 = cos_t * cos_t
                s2_ = 1.0 - c2
                r_t = -s2_ / (kappa - s2_)
                sin_p, cos_p, sin2p, cos2p = _bisect_phi_sincos(
                    pu, r_t * q, r_t * u_st,
                    POL_ITERS if op.kind == "pol" else POLC_ITERS)
                q_r = q * cos2p + u_st * sin2p
                u_r = u_st * cos2p - q * sin2p
                i_new = (kappa - s2_) - s2_ * q_r
                inv_i = 1.0 / torch.maximum(i_new, _f32(1e-7).to(dev))
                q_new = ((-s2_ + (1.0 + c2) * q_r) * inv_i).clamp(-1.0, 1.0)
                u_new = (2.0 * cos_t * u_r * inv_i).clamp(-1.0, 1.0)
                v_new = (kappa * cos_t * v_st * inv_i).clamp(-1.0, 1.0)
                # the over-purity clamp near the Mueller null
                pscale = 1.0 / _sqrt_rn(torch.maximum(
                    q_new * q_new + u_new * u_new + v_new * v_new, one))
                q_new = q_new * pscale
                u_new = u_new * pscale
                v_new = v_new * pscale
                sin_t = _sqrt_rn((1.0 - c2).clamp_min(0.0))
                e2x = dy * e1z - dz * e1y
                e2y = dz * e1x - dx * e1z
                e2z = dx * e1y - dy * e1x
                ax_ = cos_p * e1x + sin_p * e2x
                ay_ = cos_p * e1y + sin_p * e2y
                az_ = cos_p * e1z + sin_p * e2z
                nd = (cos_t * dx + sin_t * ax_, cos_t * dy + sin_t * ay_,
                      cos_t * dz + sin_t * az_)
                cval = c_val * _rsqrt_max(nd[0] * nd[0] + nd[1] * nd[1]
                                          + nd[2] * nd[2])
                for d in range(3):
                    old = f[_VX + d]
                    vn = nd[d] * cval
                    f[_VX + d] = torch.where(scatter, vn, old)
                    f[_DVX + d] = torch.where(scatter, vn - old, 0.0)
                n1 = (cos_t * ax_ - sin_t * dx, cos_t * ay_ - sin_t * dy,
                      cos_t * az_ - sin_t * dz)
                inv_e1 = _rsqrt_max(n1[0] * n1[0] + n1[1] * n1[1]
                                    + n1[2] * n1[2])
                f[st_p] = torch.where(scatter, q_new, q)
                f[st_p + 1] = torch.where(scatter, u_new, u_st)
                f[st_p + 2] = torch.where(scatter, v_new, v_st)
                for d, e1 in enumerate((e1x, e1y, e1z)):
                    f[pr_p + d] = torch.where(scatter, n1[d] * inv_e1, e1)
                if eta is not None:  # the recoil
                    E_new = f[_E] / eta
                    if op.cols:  # heating: w (E - E') over scatters
                        rec_f[k, op.cols[0]] = fsum(scatter,
                                                    f[_W] * (f[_E] - E_new))
                    f[_E] = torch.where(scatter, E_new, f[_E])
            elif op.kind in USER_OPS:
                # kernel 1i: the recorded program over this iteration's
                # planes, with t and dt of the op's place (sched rows 1 and
                # 3 after the UpdateTimeStep, 2 and 4 before it)
                row = 1 if op.after_update else 2
                if op.kind == "reduce" and op.cols[0] >= 0:
                    rec[k, op.cols[0]] = count(alive)
                if op.bins is not None:
                    RC.run_binned(op.bins, op.prog, f, alive,
                                  rec_f[k, op.cols[1]:])
                else:
                    alive = RC.run_user_program(
                        op.prog, f, alive, sched_t[row - 1][k],
                        sched_t[row + 1][k], rng, rec_f[k])
            elif op.kind == "polmeas":
                # weight, degree of polarization, V (and Q, U) sums over
                # alive particles (not photon-gated); the host divides
                st_p = _NF
                n_col, f0 = op.cols
                if n_col >= 0:
                    rec[k, n_col] = count(alive)
                wt = alive.to(torch.float32)
                if op.weighted:
                    wt = wt * f[_W]
                qs, us, vs = f[st_p], f[st_p + 1], f[st_p + 2]
                pdeg = _sqrt_rn(qs * qs + us * us + vs * vs)
                sums = [wt, wt * pdeg, wt * vs]
                if op.local_qu:
                    sums += [wt * qs, wt * us]
                for j, x in enumerate(sums):
                    rec_f[k, f0 + j] = x.sum()
            elif op.kind == "fresnel":
                # the refractive plane: photons whose segment crossed it
                # reflect (probability R) or refract, and retrace the rest
                # of the step from the intersection
                ax, loc, n_lo, n_hi, match = op.iface
                loc = _c32(loc)
                z1 = f[_RX + ax]
                z0 = z1 - f[_DRX + ax]
                side0 = z0 >= loc
                crossed = (side0 != (z1 >= loc)) & ph_alive()
                inv_speed = _rsqrt_max(f[_VX] * f[_VX] + f[_VY] * f[_VY]
                                       + f[_VZ] * f[_VZ])
                dd = [f[_VX + i] * inv_speed for i in range(3)]
                up = ~side0
                nf = torch.where(up, _c32(n_lo), _c32(n_hi))
                nt = torch.where(up, _c32(n_hi), _c32(n_lo))
                cos_i = dd[ax].abs().clamp(0.0, 1.0)
                sin2_i = 1.0 - cos_i * cos_i
                mu = nf / nt
                sin2_t = mu * mu * sin2_i
                tir = sin2_t > 1.0
                cos_tr = _sqrt_rn((1.0 - sin2_t).clamp(0.0, 1.0))
                rs = (nf * cos_i - nt * cos_tr) / (nf * cos_i + nt * cos_tr)
                rp = (nf * cos_tr - nt * cos_i) / (nf * cos_tr + nt * cos_i)
                R = torch.where(tir, 1.0,
                                (0.5 * (rs * rs + rp * rp)).clamp(0.0, 1.0))
                u = rng.uniform()
                refl = crossed & (u < R)
                s = (loc - z0) / torch.where(crossed, z1 - z0, 1.0)
                seg = dr_norm()
                sgn = torch.where(dd[ax] >= 0, 1.0, -1.0)
                d_tr = [mu * dd[i] for i in range(3)]
                d_tr[ax] = sgn * cos_tr
                inv_tr = _rsqrt_max(d_tr[0] * d_tr[0] + d_tr[1] * d_tr[1]
                                    + d_tr[2] * d_tr[2])
                if match:
                    speed_out = c_val / torch.where(refl, nf, nt)
                else:
                    speed_out = 1.0 / inv_speed
                rem = (1.0 - s) * seg * speed_out * inv_speed
                for i in range(3):
                    d_out = torch.where(refl, -dd[i] if i == ax else dd[i],
                                        d_tr[i] * inv_tr)
                    r0 = f[_RX + i] - f[_DRX + i]
                    r_new = (r0 + s * f[_DRX + i]) + d_out * rem
                    f[_RX + i] = torch.where(crossed, r_new, f[_RX + i])
                    f[_DRX + i] = torch.where(crossed, r_new - r0,
                                              f[_DRX + i])
                    f[_VX + i] = torch.where(crossed, d_out * speed_out,
                                             f[_VX + i])
            elif op.kind == "lorentz":
                # the Boris push: half E kick, exact B rotation, half E kick
                dt_l = dts_after[k] if op.after_update else dts_before[k]
                if op.qm_plane >= 0:
                    h = f[op.qm_plane] * (_f32(0.5).to(dev) * dt_l)
                else:
                    h = _f32(0.5 * op.qm).to(dev) * dt_l
                v = [f[_VX], f[_VY], f[_VZ]]
                # a recorded field at the particle's position, else the
                # constant
                E_val = (list(op.e_fn(f[_RX], f[_RY], f[_RZ]))
                         if op.e_fn is not None
                         else [_f32(x).to(dev) for x in op.e_const])
                B_val = (list(op.b_fn(f[_RX], f[_RY], f[_RZ]))
                         if op.b_fn is not None
                         else [_f32(x).to(dev) for x in op.b_const])
                if E_val:
                    ev = [x * h for x in E_val]
                    v = [v[d] + ev[d] for d in range(3)]
                if B_val:
                    tx, ty, tz = (x * h for x in B_val)
                    vx, vy, vz = v
                    vpx = vx + (vy * tz - vz * ty)
                    vpy = vy + (vz * tx - vx * tz)
                    vpz = vz + (vx * ty - vy * tx)
                    s2 = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
                    v = [vx + s2 * (vpy * tz - vpz * ty),
                         vy + s2 * (vpz * tx - vpx * tz),
                         vz + s2 * (vpx * ty - vpy * tx)]
                if E_val:
                    v = [v[d] + ev[d] for d in range(3)]
                # alive non-photons; a photon keeps v and gets dv = 0
                push = alive if is_ph is None else alive & ~is_ph
                for d in range(3):
                    new = torch.where(push, v[d], f[_VX + d])
                    f[_DVX + d] = new - f[_VX + d]
                    f[_VX + d] = new
            elif op.kind == "sign":
                n_col, sx_col = op.cols
                if n_col >= 0:
                    rec[k, n_col] = count(alive)
                for d in range(3):
                    pos = (f[_VX + d] > 0) & alive
                    if op.weighted:  # sum of w over positive movers
                        rec_f[k, sx_col + d] = fsum(pos, f[_W])
                    else:
                        rec[k, sx_col + d] = count(pos)
            elif op.kind == "emit":
                start = int(starts[op.emit_row, k])
                mask = (gid >= start) & (gid < start + op.emit_n)
                if table is not None:
                    E_new = poly_icdf_reference(rng.uniform(), table)
                    if op.emit_scale != 1.0:
                        E_new = E_new * _f32(op.emit_scale).to(dev)
                    f[_E] = torch.where(mask, E_new, f[_E])
                else:
                    f[_E] = torch.where(mask, _f32(op.emit_E).to(dev), f[_E])
                for d in range(3):
                    f[_RX + d] = torch.where(mask, _f32(op.emit_r[d]).to(dev),
                                             f[_RX + d])
                    f[_DRX + d] = torch.where(mask, 0.0, f[_DRX + d])
                    f[_DVX + d] = torch.where(mask, 0.0, f[_DVX + d])
                if op.emit_v is not None:
                    vnew = [_f32(x).to(dev) for x in op.emit_v]
                else:
                    vnew = direction(c_val, *rng.uniform_pair())
                for d in range(3):
                    f[_VX + d] = torch.where(mask, vnew[d], f[_VX + d])
                f[_W] = torch.where(mask, 1.0, f[_W])
                # fresh photons: zeroed extras (a polarized source's Stokes
                # and frame rows instead), and photons in the otype plane,
                # so that this chunk's photon ops see them
                fill = {}
                if op.emit_stokes:
                    fill = dict(zip(POL_ROWS, (*op.emit_stokes,
                                               *op.emit_polref)))
                for j, name in enumerate(plan.extras):
                    if name != "otype":
                        f[_NF + j] = torch.where(
                            mask, _f32(fill.get(name, 0.0)).to(dev),
                            f[_NF + j])
                if p_otype >= 0:
                    f[p_otype] = torch.where(mask, float(OBJ_PHOTON),
                                             f[p_otype])
                    is_ph = f[p_otype] == OBJ_PHOTON
                alive = alive | mask
                f[_ALIVE] = alive.to(torch.float32)
            elif op.kind == "cross":
                (n_col,) = op.cols
                if n_col >= 0:
                    rec[k, n_col] = count(alive)
                for ax in op.axes:
                    axis, L, col, e_col, ecap = _axis(ax)
                    hi = f[_RX + axis]
                    lo = hi - f[_DRX + axis]
                    Lv = _f32(L).to(dev)
                    crossed = (((lo <= Lv) & (Lv <= hi))
                               | ((lo >= Lv) & (Lv >= hi))) & alive
                    if op.weighted:
                        rec_f[k, col] = fsum(crossed, f[_W])
                    else:
                        rec[k, col] = count(crossed)
                    if e_col >= 0:
                        flux = f[_W] * f[_E] if op.weighted else f[_E]
                        rec_f[k, e_col] = fsum(crossed, flux)
                    if ecap >= 0 and sample:  # E where crossed, NaN else
                        planes[ecap] = torch.where(crossed, f[_E], _NAN)
        rec[k, 0] = count(alive)
        if sample:
            # float32 -> bfloat16 rounds to nearest even, as the kernel
            stream[k // every] = torch.stack(planes).to(stream.dtype)
    if stream is not None:
        return torch.stack(f), rec, rec_f, stream
    return torch.stack(f), rec, rec_f


def bin_constants(op: _Op) -> list:
    """A binned reduce's constants in ``Plan::fk``: its program's (in
    ``ops/fields.py:field_layout`` order, as ``ops/codegen.py:binned_c``
    reads them), then its edges' search table (``Bins.search_table``)."""
    spec = {"n_out": 1 + (not op.bins.count), "prog": op.prog}
    return (FL.field_layout(spec)[1]
            + [float(x) for x in op.bins.search_table()])


def bin_offsets(ops, k0: int) -> dict:
    """``{op index: first constant in Plan::fk}`` of the binned reduces,
    whose constants (:func:`bin_constants`) follow the expression fields'
    ``k0`` in op order: where ``_plan_struct`` writes them and where the
    form library (``ops/codegen.py:plan_form``) reads them, a constant of
    the form."""
    out = {}
    for i, op in enumerate(ops):
        if op.bins is not None:
            out[i] = k0
            k0 += len(bin_constants(op))
    return out


def _set_field(fs, spec, n_fk, aux):
    """Fill one kernel ``Field`` from a spec; an expression field's
    constants start at ``fk[n_fk]`` (its shape goes to ``shape``: the
    program is the form library's) and layered edges and values append to
    the auxiliary table ``aux`` (a list of float32 arrays, offsets in
    floats). Returns the next field's first constant."""
    fs.kind = FL.KIND_CODES[spec["kind"]]
    if spec["kind"] == "expr":
        fs.shape, consts = FL.field_layout(spec)
        fs.off, fs.len = n_fk, len(consts)
        n_fk += len(consts)
    elif spec["kind"] == "layered":
        fs.axis, fs.outside = spec["axis"], spec["outside"]
        fs.ctr[:] = list(spec["center"])
        fs.off = sum(a.size for a in aux)
        fs.len = len(spec["values"])
        aux += [spec["edges"], spec["values"]]
    else:
        fs.interp = int(spec["interp"] == "trilinear")
        fs.n[:] = list(spec["shape"])
        fs.org[:] = list(spec["origin"])
        fs.sp[:] = list(spec["spacing"])
        fs.outside = spec["outside"]
    return n_fk


def _plan_struct(plan: FusedPlan, dev: torch.device):
    """The kernel's ``Plan`` struct (ctypes, sized for the plan's ops,
    crossing planes, fields and expression-field constants; built once per
    plan and device: it holds the device voxel grids' addresses), the
    auxiliary float table on ``dev`` (the fit tables of sampled-energy emit
    ops, then the layered fields' edges and values) or None, and the
    grids."""
    key = ("struct", dev)
    if key in plan._cache:
        return plan._cache[key]
    from physicl_tpu_torch.ops._build import plan_struct_type

    specs, index = _field_index(plan.ops)
    fk = []
    for sp in specs:
        if sp["kind"] == "expr":
            fk.extend(FL.field_layout(sp)[1])
    for i in bin_offsets(plan.ops, len(fk)):
        fk.extend(bin_constants(plan.ops[i]))
    ps = plan_struct_type((len(plan.ops), sum(len(op.axes)
                                              for op in plan.ops),
                           len(specs), len(fk)))()
    aux, grids = [], []
    n_ax = 0
    for i, op in enumerate(plan.ops):
        o = ps.ops[i]
        o.kind = OP_CODES[op.kind]
        o.col0 = op.cols[0] if op.cols else -1
        o.col1 = op.cols[1] if len(op.cols) > 1 else -1
        o.coef, o.wl_base, o.c_val = op.coef, op.wl_base or 0.0, op.c_val
        o.nf, o.af = _slot(index, op.n_fn), _slot(index, op.a_fn)
        o.fld[:] = [_slot(index, fn) for fn in op.fld_fns]
        if op.kind in ("iso", "hg", "rayl", "phase"):
            o.flag = int(op.wl_base is not None)
        if op.kind == "del":
            o.capture = int(op.implicit_capture)
            o.w_min, o.w_sur = op.roulette or (0.0, 0.0)
            # DelVariant: 1 exponential transform, 2 fluorescence; their
            # parameters in box
            o.flag = 1 if op.stretch else (2 if op.fluor else 0)
            params = op.stretch or op.fluor
            o.box[:len(params)] = [float(x) for x in params]
        elif op.kind == "hg":
            # the float32 folds of the JAX trace: 1 - g^2, 1 - g, 2g, 1 + g^2
            gg, one = np.float32(op.g), np.float32(1.0)
            o.box[:4] = [float(one - gg * gg), float(one - gg),
                         float(gg + gg), float(one + gg * gg)]
            o.flag |= 2 * int(abs(op.g) < 1e-7)  # the isotropic limit
        elif op.kind == "phase" and op.phase_knots is not None:
            m0, dm = op.phase_knots
            o.icdf, o.emit_n = sum(a.size for a in aux), m0.size
            aux += [m0, dm]
        elif op.kind == "compton":
            o.box[:2] = [op.inv_mec2, op.theta_e]
            o.flag = 2 * int(op.kn_xsec)
            o.emit_n = op.kn_tries
        elif op.kind == "fresnel":
            axis, loc, n_lo, n_hi, match = op.iface
            o.col1, o.flag = int(axis), int(match)
            o.box[:3] = [loc, n_lo, n_hi]
        elif op.kind == "sign":
            o.flag = int(op.weighted)
        elif op.kind == "pol":
            o.flag = int(op.wl_base is not None)
        elif op.kind == "polc":
            o.box[0] = op.inv_mec2
            o.flag = 2 * int(op.kn_xsec)
            o.emit_n = op.kn_tries
        elif op.kind == "polmeas":  # PolmeasFlag: weighted 1, local_qu 2
            o.flag = int(op.weighted) | 2 * int(op.local_qu)
        elif op.kind in USER_OPS:
            # the program is the plan's library's (ops/codegen.py):
            # emit_row draws, flag 1 = t and dt after the UpdateTimeStep;
            # col0 a reduce's count column
            o.emit_row = op.prog.n_draws
            o.flag = int(op.after_update)
            if op.bins is not None:
                # its constants in fk (bin_offsets) are the form's
                o.flag |= USER_BINNED
        elif op.kind == "lorentz":
            # LorentzFlag: E 1, B 2, the dt after the update 4; the
            # species-wide 0.5 q/m rounded to float32 (jnp.float32(0.5 *
            # qm)), or the q/m plane's index among the extras
            o.flag = (int(bool(op.e_const) or op.e_fn is not None)
                      | 2 * int(bool(op.b_const) or op.b_fn is not None)
                      | 4 * int(op.after_update))
            o.coef = 0.5 * op.qm
            o.col0 = op.qm_plane - _NF if op.qm_plane >= 0 else -1
            o.box[:] = [float(x) for x in (op.e_const or (0.0,) * 3)
                        + (op.b_const or (0.0,) * 3)]
        elif op.kind in ("absorb", "reflect", "periodic"):
            o.box[:] = [float(x) for lohi in op.bounds for x in lohi]
        elif op.kind in ("sabsorb", "scross"):
            # the sphere lives in box[0..3]
            o.box[:4] = [float(x) for x in op.sphere]
            o.flag = int(op.inside if op.kind == "sabsorb" else op.weighted)
        elif op.kind == "trace":
            o.col1 = op.stream0   # the first stream plane
            o.flag = int(op.stream_scat)
        elif op.kind == "emit":
            o.flag = int(op.emit_v is None)
            o.emit_n, o.emit_row, o.emit_E = op.emit_n, op.emit_row, op.emit_E
            o.emit_scale = op.emit_scale
            o.emit_r[:] = [float(x) for x in op.emit_r]
            o.emit_v[:] = [float(x) for x in (op.emit_v or (0.0,) * 3)]
            # a polarized source: its Stokes vector, then its frame
            o.capture = int(bool(op.emit_stokes))
            if op.emit_stokes:
                o.box[:] = [float(x) for x in (*op.emit_stokes,
                                               *op.emit_polref)]
            o.icdf = -1
            if op.emit_table is not None:
                o.icdf = sum(a.size for a in aux)
                aux.append(op.emit_table)
        elif op.kind == "cross":
            o.flag = int(op.weighted)
            o.ax0, o.n_ax = n_ax, len(op.axes)
            for ax in op.axes:
                a = ps.axes[n_ax]
                a.axis, a.L, a.col, a.ecol, a.ecap = _axis(ax)
                n_ax += 1
    n_fk = 0
    for i, spec in enumerate(specs):
        n_fk = _set_field(ps.fields[i], spec, n_fk, aux)
        if spec["kind"] == "voxel":
            grid = FL.grid_on(spec, dev)  # shared with the twin's callable
            grids.append(grid)
            ps.grids[i] = grid.data_ptr()
    ps.fk[:len(fk)] = fk
    ps.n_ops = len(plan.ops)
    ps.n_cols, ps.n_fcols = plan.n_rec_cols, plan.n_frec_cols
    ps.const_norm = int(plan.const_norm_speed is not None)
    ps.const_speed = plan.const_norm_speed or 0.0
    ps.n_stream, ps.stream_every = plan.n_stream, plan.stream_every
    ps.stream_bf16 = int(plan.stream_dtype == "bfloat16")
    ps.n_extras = len(plan.extras)
    ps.otype_x = (plan.extras.index("otype")
                  if plan.species == SPECIES_MIXED else -1)
    # the Stokes and frame planes written back (kPol), and every other
    # written-back plane (kernel 1i's extras_write)
    ps.wb_mask = plan.plane_mask(set(plan.extras_writeback)
                                 & set(_POL_BASES))
    ps.uwb_mask = plan.plane_mask(set(plan.extras_writeback)
                                  - set(_POL_BASES))
    if plan.has_pol:
        ps.rot_sd[:], ps.rot_cd[:] = (t.tolist() for t in rot_table())
    # once per plan and device: no copy on the dispatch path
    aux = (torch.from_numpy(np.concatenate(aux).astype(np.float32)).to(dev)
           if aux else None)
    plan._cache[key] = (ps, aux, grids)
    return plan._cache[key]


def fused_transport(packed: torch.Tensor, out: torch.Tensor,
                    sched: torch.Tensor, seed: int, k_act: int,
                    plan: FusedPlan, emit_starts: torch.Tensor | None = None):
    """Launch ``csrc/fused_transport.cu`` on CUDA tensors: ``k_act``
    iterations of ``plan`` from ``packed`` into ``out`` (which may be
    ``packed`` itself; out of place, the extras planes are copied over
    first, since the kernel writes them only for the slots an emit op
    fills). ``sched`` is the ``(5, >= chunk)`` schedule (row 0 the dt at
    kinematics, rows 3 and 4 the dt after and before the UpdateTimeStep).
    ``emit_starts`` is the ``(n_emit, chunk)`` int32 emit schedule on the
    same device (plans with emit ops only). Returns
    ``(rec, rec_f)``, and for plans with stream planes ``(rec, rec_f,
    stream)`` with a fresh stream buffer (the kernel writes every row, NaN
    at and past ``ceil(k_act / stream_every)``). A plan of an op-sequence
    form (``plan.kernel_seq``) launches that sequence's instantiation, with
    its per-iteration collision thresholds (:func:`scatter_threshold`);
    every other plan its form's library (:func:`_library`), built at its
    first launch. Raises on a CPU tensor, a failed build or a refused
    launch.
    ``fused_transport.launches`` counts launches, and
    ``fused_transport.seq_launches`` those of the op-sequence
    instantiations among them."""
    from physicl_tpu_torch.ops import _build

    _check_plan(plan)
    for name, t in (("packed", packed), ("out", out), ("sched", sched)):
        if t.device.type != "cuda":
            raise ValueError(f"fused_transport: {name} is not a CUDA tensor")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_transport: {name} must be contiguous "
                             "float32")
    if packed.shape != out.shape or packed.shape[0] != plan.n_planes:
        raise ValueError(f"fused_transport: packed/out must be "
                         f"({plan.n_planes}, C), got {tuple(packed.shape)} "
                         f"/ {tuple(out.shape)}")
    if packed.shape[1] % _LANE:
        raise ValueError("fused_transport: capacity must be a multiple of "
                         f"{_LANE}")
    if not 0 <= int(k_act) <= plan.chunk <= sched.shape[1] \
            or sched.shape[0] < 5:
        raise ValueError("fused_transport: need 0 <= k_act <= chunk <= "
                         "sched width and 5 sched rows")
    dev = packed.device
    starts_ptr, stride = 0, 0
    if plan.n_emit:
        if (emit_starts is None or emit_starts.device != dev
                or emit_starts.dtype != torch.int32
                or not emit_starts.is_contiguous()
                or emit_starts.shape[0] < plan.n_emit
                or emit_starts.shape[1] < plan.chunk):
            raise ValueError("fused_transport: emit ops need a contiguous "
                             "int32 (n_emit, chunk) emit_starts on the "
                             "packed state's device")
        starts_ptr, stride = emit_starts.data_ptr(), emit_starts.shape[1]
    struct, aux, _ = _plan_struct(plan, dev)
    lib = _library(plan)
    if lib.plan_dims != type(struct).dims:
        raise RuntimeError(f"fused_transport: the library's Plan sizes "
                           f"{lib.plan_dims} are not the plan's "
                           f"{type(struct).dims}")
    plan_dev = _plan_buffer(plan, struct, dev)
    C, k_act = packed.shape[1], int(k_act)
    rec = torch.zeros((plan.chunk, _MAX_REC_COLS), dtype=torch.int32,
                      device=dev)
    rec_f = torch.zeros((plan.chunk, _MAX_REC_COLS), dtype=torch.float32,
                        device=dev)
    stream = None
    if plan.n_stream:
        # fresh per launch: trace steps keep earlier chunks' buffers
        stream = torch.empty((plan.n_stream_rows, plan.n_stream, C),
                             dtype=plan.stream_torch_dtype, device=dev)
    if plan.extras and out.data_ptr() != packed.data_ptr():
        out[_NF:].copy_(packed[_NF:])
    variant = kernel_variant(plan)
    thr = None
    if plan.kernel_seq is not None:
        thr = scatter_threshold(pcoll_row(plan, sched)).contiguous()
    with torch.cuda.device(dev):
        grid = kernel_grid(plan, C, k_act)
        # each warp's [k_act][n_fcols] slice (the kernel's 8 warps a block)
        partials = torch.empty(max(1, grid * 8 * k_act * plan.n_frec_cols),
                               dtype=torch.float32, device=dev)
        err = lib.fused_transport_launch(
            packed.data_ptr(), out.data_ptr(), C, sched.data_ptr(),
            sched.shape[1], 0 if thr is None else thr.data_ptr(),
            starts_ptr, stride,
            0 if aux is None else aux.data_ptr(), k_act,
            int(seed) & 0xFFFFFFFF, ctypes.addressof(struct),
            0 if plan_dev is None else plan_dev.data_ptr(), variant, grid,
            rec.data_ptr(), rec_f.data_ptr(), partials.data_ptr(),
            0 if stream is None else stream.data_ptr(),
            plan.n_stream_rows if plan.n_stream else 0,
            0 if stream is None else stream.element_size(),
            _build.stream_of(packed))
    _build.check(err, "fused_transport launch")
    fused_transport.launches += 1
    if thr is not None:
        fused_transport.seq_launches += 1
    if stream is not None:
        return rec, rec_f, stream
    return rec, rec_f


fused_transport.launches = 0
fused_transport.seq_launches = 0


def rsqrt_near1_check(dev) -> dict:
    """The card's exhaustive check of the op-sequence instantiations'
    reciprocal root (``csrc/fused_transport.cu: rsqrt_rn_near1``, the
    compiler's correctly rounded ``1.0f / sqrtf`` without its range tests):
    ``mismatches``, the float32 of [0.5, 2) where the two differ in any bit,
    and ``out_of_range``, the 32-bit draw pairs whose unnormalised
    direction's squared norm leaves [0.5, 2); both must be 0. ``n2_min`` and
    ``n2_max`` are the extremes of that squared norm."""
    from physicl_tpu_torch.ops import _build

    out = torch.tensor([0, 0, -1, 0], dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.load()["fused_transport"]
                     .fused_transport_rsqrt_check(out.data_ptr(),
                                                  _build.stream_of(out)),
                     "fused_transport rsqrt check")
    bad, out_of_range, lo, hi = out.tolist()
    as_f32 = np.array([lo & _MASK, hi & _MASK], np.uint32).view(np.float32)
    return {"mismatches": bad, "out_of_range": out_of_range,
            "n2_min": float(as_f32[0]), "n2_max": float(as_f32[1])}


def _plan_buffer(plan: FusedPlan, struct, dev):
    """The device copy of the plan's ``Plan`` where its form library takes
    it from a buffer (``ops/codegen.py:plan_in_buffer``), made once per
    plan and device; else None."""
    if plan.kernel_seq is not None:
        return None
    from physicl_tpu_torch.ops import codegen

    if not codegen.plan_in_buffer(plan, struct):
        return None
    key = ("plan_dev", dev)
    if key not in plan._cache:
        plan._cache[key] = torch.frombuffer(
            bytearray(bytes(struct)), dtype=torch.uint8).to(dev)
    return plan._cache[key]


def kernel_variant(plan: FusedPlan) -> int:
    """The ``variant`` a launch of ``plan`` passes: its op sequence's
    (``SEQ_VARIANTS``) in the main library, or ``FORM_VARIANT`` in its form
    library."""
    seq = plan.kernel_seq
    return FORM_VARIANT if seq is None else SEQ_VARIANTS[seq]


def _library(plan: FusedPlan):
    """The built library that runs the plan: the main one for an
    op-sequence plan (``kernel_seq``), else its form's own, generated from
    its structure (``ops/codegen.py:form_source``), built at its first
    launch and kept with the plan. A failed build raises, naming the plan
    and quoting ``nvcc``."""
    from physicl_tpu_torch.ops import _build

    if plan.kernel_seq is not None:
        return _build.load()["fused_transport"]
    if "lib" not in plan._cache:
        from physicl_tpu_torch.ops import codegen

        plan._cache["lib"] = _build.load_plan(
            codegen.form_source(plan), f"the plan {codegen.plan_label(plan)}")
    return plan._cache["lib"]


def kernel_grid(plan: FusedPlan, capacity: int, k_act: int) -> int:
    """The grid (blocks) a ``fused_transport`` launch of ``plan`` takes on
    the current CUDA device: the occupancy limit of its kernel with its
    count tile's shared memory times the SM count, capped by the tiles."""
    from physicl_tpu_torch.ops import _build

    lib = _library(plan)
    grid = ctypes.c_int(0)
    _build.check(lib.fused_transport_grid(
        capacity, k_act, plan.n_rec_cols, plan.n_frec_cols,
        kernel_variant(plan), ctypes.byref(grid)),
        "fused_transport occupancy query")
    return grid.value


def fused_chunk(packed: torch.Tensor, sched: torch.Tensor, seed: int,
                k_act: int, plan: FusedPlan, out: torch.Tensor | None = None,
                emit_starts: torch.Tensor | None = None):
    """One fused chunk: ``(out, rec, rec_f)``, and the stream buffer last
    for plans with stream planes.

    A CPU ``packed`` runs :func:`fused_chunk_reference`; a CUDA ``packed``
    runs :func:`fused_transport` into ``out`` (default: ``packed``, in
    place — the JAX call aliases its state the same way)."""
    if packed.device.type == "cpu":
        return fused_chunk_reference(packed, sched, seed, k_act, plan,
                                     emit_starts)
    if out is None:
        out = packed
    return (out, *fused_transport(packed, out, sched, seed, k_act, plan,
                                  emit_starts))


def clear_kernel_cache() -> None:
    """The JAX package's ``clear_kernel_cache`` drops compiled chunks keyed
    on a snapshot of the user callables' state, so that a callable reading
    a mutated module global is traced again. The port keeps no such cache:
    every ``start()`` records its callables and builds its plan afresh, and
    the kernel libraries depend only on the sources. So there is nothing
    to drop; the function is kept for the JAX package's public surface."""


def pack_state(state: SimState, extras: tuple = ()) -> torch.Tensor:
    """SimState -> packed ``(15 + len(extras), C)`` float32. ``extras``
    names resolve against ``state.extras``: ``"qm"`` packs the derived
    charge-to-mass ratio ``q / m`` (0 where ``m == 0``, so an uncharged or
    massless particle is never pushed), ``"otype"`` the species codes of a
    mixed population, ``"name:i"`` row ``i`` of a 3-row extras array."""
    f32 = torch.float32
    planes = [state.r, state.dr, state.v, state.dv,
              state.E[None].to(f32), state.alive[None].to(f32),
              state.w[None].to(f32)]
    for name in extras:
        if name == "qm":
            q = state.extras["q"].to(f32)
            m = state.extras["m"].to(f32)
            safe = torch.where(m != 0, m, torch.ones_like(m))
            planes.append(torch.where(m != 0, q / safe, 0.0)[None])
        elif name == "otype":
            planes.append(state.otype.to(f32)[None])
        elif ":" in name:
            base, i = name.rsplit(":", 1)
            planes.append(state.extras[base][int(i)].to(f32)[None])
        else:
            planes.append(state.extras[name].to(f32)[None])
    return torch.cat(planes, dim=0).contiguous()


def unpack_state(packed: torch.Tensor, template: SimState,
                 extras: tuple = (), writeback: tuple = ()) -> SimState:
    """Packed ``(15 + n_extras, C)`` -> SimState. The vector fields are
    views of ``packed``, so the state shares its storage. ``writeback``
    names the extras bases the kernel mutated (``FusedPlan.
    extras_writeback``): a scalar plane packed as ``"name"``, or the rows
    ``"name:0"`` .. ``"name:2"`` of a 3-row one (a view where the prover
    packed them in order, as it does), replace ``template.extras[name]``.
    Every other extras plane
    stays with the host's ``template.extras`` and ``otype``: the kernel
    changes them only in the slots an emit op fills, which the provider
    retypes and zeroes itself."""
    state = template.replace(
        r=packed[_RX:_RX + 3], dr=packed[_DRX:_DRX + 3],
        v=packed[_VX:_VX + 3], dv=packed[_DVX:_DVX + 3],
        E=packed[_E].to(template.E.dtype),
        alive=packed[_ALIVE] > 0,
        w=packed[_W].to(template.w.dtype),
    )
    if not writeback:
        return state
    new_extras = dict(template.extras)
    for base in writeback:
        dtype = template.extras[base].dtype
        if base in extras:  # a scalar plane, packed under its name
            new_extras[base] = packed[_NF + extras.index(base)].to(dtype)
            continue
        rows = [_NF + extras.index(f"{base}:{i}") for i in range(3)]
        if rows == list(range(rows[0], rows[0] + 3)):
            new_extras[base] = packed[rows[0]:rows[0] + 3].to(dtype)
        else:
            new_extras[base] = packed[rows].to(dtype)
    return state.replace(extras=new_extras)
